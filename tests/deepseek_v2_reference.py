"""Plain float32 reference of DeepSeek-V2's forward pass, held against
``optimized_rag_tpu_torch/models/deepseek_v2.py`` in the tests.

Plain ``torch`` only: it imports neither JAX nor anything of the port, keeps
no cache and batches nothing; one unpadded sequence of ids goes in, its
logits at every position come out, in float32 with TF32 off. It follows
``modeling_deepseek.py`` of huggingface.co/deepseek-ai/DeepSeek-V2-Lite,
configured by the keys of that model's ``config.json`` (``cfg``, a dict).

``params`` are the tensors by the port's state-dict names (any dtype; used
in float32). Departures from the published code, all in its favour of
precision or layout and none of the function:

* everything is float32 (the published code rounds activations to bf16);
* cos and sin of RoPE stay float32 (the published code rounds them to the
  model dtype);
* the routed experts are stored stacked, ``mlp.experts.gate_up_proj`` [E,
  2 I, H] (each expert's gate rows, then its up rows) and
  ``mlp.experts.down_proj`` [E, H, I], where the published checkpoint has
  one ``gate_proj`` / ``up_proj`` / ``down_proj`` per expert;
* the MoE runs a loop over tokens, each token through its top-k experts
  (the published ``moe_infer`` groups tokens by expert), the same sum.
"""

from __future__ import annotations

import math

import torch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _yarn_get_mscale(scale=1.0, mscale=1.0):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_find_correction_dim(num_rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_inv_freq_and_mscale(cfg: dict):
    """DeepseekV2YarnRotaryEmbedding's inverse frequencies [d/2] and the
    factor on cos and sin."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2,
                                              dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(
        0, dim, 2, dtype=torch.float32) / dim))
    low = math.floor(_yarn_find_correction_dim(rs["beta_fast"], dim, base,
                                               orig))
    high = math.ceil(_yarn_find_correction_dim(rs["beta_slow"], dim, base,
                                               orig))
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    mscale = (_yarn_get_mscale(factor, rs["mscale"])
              / _yarn_get_mscale(factor, rs["mscale_all_dim"]))
    return inv_freq, mscale


def softmax_scale(cfg: dict) -> float:
    q_head_dim = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    scale = q_head_dim ** -0.5
    rs = cfg.get("rope_scaling")
    if rs:
        m = _yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def cos_sin(cfg: dict, length: int, device):
    inv_freq, mscale = yarn_inv_freq_and_mscale(cfg)
    t = torch.arange(length, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return (emb.cos() * mscale).to(device), (emb.sin() * mscale).to(device)


def rotate_half(x):
    x1 = x[..., : x.shape[-1] // 2]
    x2 = x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary(x, cos, sin):
    """x [..., L, d] with DeepSeek's interleaved-to-halves permutation."""
    *lead, d = x.shape
    x = x.view(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    return x * cos + rotate_half(x) * sin


def rms_norm(x, weight, eps):
    var = x.pow(2).mean(-1, keepdim=True)
    return weight * (x * torch.rsqrt(var + eps))


def swiglu(x, gate, up, down):
    return (torch.nn.functional.silu(x @ gate.T) * (x @ up.T)) @ down.T


def attention(p, cfg, x, cos, sin):
    """MLA over one sequence x [L, H], causal."""
    n = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    length = x.shape[0]
    q = (x @ p["q_proj.weight"].T).view(length, n, dn + dr).transpose(0, 1)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = x @ p["kv_a_proj_with_mqa.weight"].T
    c, k_pe = ckv[:, :r], ckv[:, r:]
    c = rms_norm(c, p["kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = (c @ p["kv_b_proj.weight"].T).view(length, n, dn + dv
                                             ).transpose(0, 1)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_pe = apply_rotary(q_pe, cos, sin)
    k_pe = apply_rotary(k_pe[None], cos, sin)
    qs = torch.cat([q_nope, q_pe], dim=-1)
    ks = torch.cat([k_nope, k_pe.expand(n, -1, -1)], dim=-1)
    w = (qs @ ks.transpose(1, 2)) * softmax_scale(cfg)
    mask = torch.ones(length, length, dtype=torch.bool,
                      device=x.device).tril()
    w = torch.softmax(w.masked_fill(~mask, float("-inf")), dim=-1)
    o = (w @ v).transpose(0, 1).reshape(length, n * dv)
    return o @ p["o_proj.weight"].T


def route(p, cfg, x):
    """Greedy top-k of the softmax router: (ids [L, k], weights [L, k])."""
    scores = torch.softmax(x @ p["gate.weight"].T, dim=-1)
    w, idx = torch.topk(scores, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        w = w * cfg["routed_scaling_factor"]
    return idx, w


def moe(p, cfg, x):
    """Each token through its top-k experts, weighted, plus the shared
    experts."""
    idx, w = route(p, cfg, x)
    width = cfg["moe_intermediate_size"]
    gu, down = p["experts.gate_up_proj"], p["experts.down_proj"]
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for e, we in zip(idx[t].tolist(), w[t]):
            out[t] += we * swiglu(x[t:t + 1], gu[e, :width], gu[e, width:],
                                  down[e])[0]
    shared = swiglu(x, p["shared_experts.gate_proj.weight"],
                    p["shared_experts.up_proj.weight"],
                    p["shared_experts.down_proj.weight"])
    return out + shared


def is_moe(cfg: dict, layer: int) -> bool:
    return (cfg["n_routed_experts"] is not None
            and layer >= cfg["first_k_dense_replace"]
            and layer % cfg["moe_layer_freq"] == 0)


def sub(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v.float() for k, v in params.items()
            if k.startswith(prefix)}


def forward(params: dict, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """Float32 logits [L, V] of one sequence of ids [L]."""
    no_tf32()
    eps = cfg["rms_norm_eps"]
    x = params["embed_tokens.weight"].float()[ids]
    cos, sin = cos_sin(cfg, ids.shape[0], x.device)
    for i in range(cfg["num_hidden_layers"]):
        p = sub(params, f"layers.{i}.")
        x = x + attention(sub(p, "self_attn."), cfg,
                          rms_norm(x, p["input_layernorm.weight"], eps),
                          cos, sin)
        h = rms_norm(x, p["post_attention_layernorm.weight"], eps)
        m = sub(p, "mlp.")
        if is_moe(cfg, i):
            x = x + moe(m, cfg, h)
        else:
            x = x + swiglu(h, m["gate_proj.weight"], m["up_proj.weight"],
                           m["down_proj.weight"])
    x = rms_norm(x, params["norm.weight"].float(), eps)
    return x @ params["lm_head.weight"].float().T
