"""Plain float32 reference of Kimi Linear's forward pass, held against
``optimized_rag_tpu_torch/models/kimi_linear.py`` in the tests.

Plain ``torch`` only: it imports neither JAX nor anything of the port, keeps
no cache and batches nothing; one unpadded sequence of ids goes in, its
logits at every position come out, in float32 with TF32 off. It follows the
Kimi Linear report (arXiv:2510.26692) and the layers of the published
``modeling_kimi.py`` (huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct),
configured by the keys of that model's ``config.json`` (``cfg``, a dict).

KDA runs as its token recurrence (``kda_recurrence``). Where ``cfg`` holds
``expert_parallel: {"ranks": R, "rank": i}``, the MoE layers hold
``num_experts`` experts, ids ``i * num_experts`` on, of a router over
``R * num_experts``, and a pick of an absent expert adds nothing: one
rank's share.

``params`` are the tensors by the port's state-dict names (any dtype; used
in float32). Departures from the published code, none of the function:
everything is float32; the routed experts are stored stacked
(``mlp.experts.gate_up_proj`` [E, 2 I, H], each expert's gate rows then its
up rows, and ``mlp.experts.down_proj`` [E, H, I]); the MoE runs a loop over
tokens.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sub(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v.float() for k, v in params.items()
            if k.startswith(prefix)}


def rms_norm(x, weight, eps):
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate.T) * (x @ up.T)) @ down.T


def kda_layers(cfg: dict) -> set:
    return {i - 1 for i in cfg["linear_attn_config"]["kda_layers"]}


def share(cfg: dict) -> tuple[int, int, int]:
    """(first held id, experts held, the router's width)."""
    ep = cfg.get("expert_parallel") or {"ranks": 1, "rank": 0}
    held = cfg["num_experts"]
    return ep["rank"] * held, held, ep["ranks"] * held


def mla(p, cfg, x):
    """NoPE MLA over one sequence x [L, H], causal."""
    n = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, length = cfg["kv_lora_rank"], x.shape[0]
    q = (x @ p["q_proj.weight"].T).view(length, n, dn + dr).transpose(0, 1)
    ckv = x @ p["kv_a_proj_with_mqa.weight"].T
    c = rms_norm(ckv[:, :r], p["kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    kv = (c @ p["kv_b_proj.weight"].T).view(length, n, dn + dv
                                             ).transpose(0, 1)
    k = torch.cat([kv[..., :dn], ckv[None, :, r:].expand(n, -1, -1)], -1)
    w = (q @ k.transpose(1, 2)) * (dn + dr) ** -0.5
    mask = torch.ones(length, length, dtype=torch.bool,
                      device=x.device).tril()
    w = torch.softmax(w.masked_fill(~mask, float("-inf")), dim=-1)
    o = (w @ kv[..., dn:]).transpose(0, 1).reshape(length, n * dv)
    return o @ p["o_proj.weight"].T


def short_conv(x, weight):
    """SiLU of the depthwise causal convolution of x [L, D] (zeros before
    the first position) by weight [D, 1, K]."""
    taps = weight.shape[-1]
    xp = torch.cat([x.new_zeros(taps - 1, x.shape[1]), x])
    y = sum(xp[j:j + x.shape[0]] * weight[:, 0, j] for j in range(taps))
    return F.silu(y)


def l2norm(x, eps=1e-6):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + eps)


def kda_recurrence(q, k, v, g, beta, state=None):
    """The gated delta rule token by token: q, k, g [L, h, d_k], v [L, h,
    d_v], beta [L, h] -> (o [L, h, d_v], the final state [h, d_k, d_v])."""
    length, n, dk = k.shape
    s = (q.new_zeros(n, dk, v.shape[-1]) if state is None else state)
    out = []
    for t in range(length):
        s = g[t].exp()[..., None] * s
        kv = torch.einsum("hkv,hk->hv", s, k[t])
        s = s + beta[t][:, None, None] * k[t][..., None] * (v[t] - kv)[
            :, None, :]
        out.append(torch.einsum("hkv,hk->hv", s, q[t]))
    return torch.stack(out), s


def kda_inputs(p, cfg, x):
    """(q, k, v, g, beta) of KDA's recurrence for x [L, H]."""
    lac = cfg["linear_attn_config"]
    n, d, length = lac["num_heads"], lac["head_dim"], x.shape[0]
    q, k, v = (short_conv(x @ p[f"{a}_proj.weight"].T,
                          p[f"{a}_conv1d.weight"]).view(length, n, d)
               for a in "qkv")
    q, k = l2norm(q) * d ** -0.5, l2norm(k)
    beta = torch.sigmoid(x @ p["b_proj.weight"].T)
    f = (x @ p["f_a_proj.weight"].T) @ p["f_b_proj.weight"].T
    g = -p["A_log"].exp()[:, None] * F.softplus(
        f + p["dt_bias"]).view(length, n, d)
    return q, k, v, g, beta


def kda_output(p, cfg, x, o):
    """``W_o`` of the gated, per-head normed o [L, h, d_v]."""
    gate = torch.sigmoid((x @ p["g_a_proj.weight"].T) @ p["g_b_proj.weight"].T
                         + p["g_b_proj.bias"]).view(o.shape)
    o = rms_norm(o, p["o_norm.weight"], cfg["rms_norm_eps"]) * gate
    return o.flatten(1) @ p["o_proj.weight"].T


def kda(p, cfg, x):
    o, _ = kda_recurrence(*kda_inputs(p, cfg, x))
    return kda_output(p, cfg, x, o)


def route(p, cfg, x):
    """The sigmoid router: (router ids [L, k], weights [L, k])."""
    scores = torch.sigmoid(x @ p["gate.weight"].T)
    idx = torch.topk(scores + p["gate.e_score_correction_bias"],
                     cfg["num_experts_per_token"], dim=-1).indices
    w = scores.gather(1, idx)
    if cfg["moe_renormalize"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * cfg["routed_scaling_factor"]


def moe(p, cfg, x):
    """Each token through its top-k experts that this share holds,
    weighted, plus the shared experts."""
    idx, w = route(p, cfg, x)
    first, held, _ = share(cfg)
    width = cfg["moe_intermediate_size"]
    gu, down = p["experts.gate_up_proj"], p["experts.down_proj"]
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for e, we in zip(idx[t].tolist(), w[t]):
            e -= first
            if 0 <= e < held:
                out[t] += we * swiglu(x[t:t + 1], gu[e, :width],
                                      gu[e, width:], down[e])[0]
    return out + swiglu(x, p["shared_experts.gate_proj.weight"],
                        p["shared_experts.up_proj.weight"],
                        p["shared_experts.down_proj.weight"])


def forward(params: dict, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """Float32 logits [L, V] of one sequence of ids [L]."""
    no_tf32()
    eps = cfg["rms_norm_eps"]
    linear = kda_layers(cfg)
    x = params["embed_tokens.weight"].float()[ids]
    for i in range(cfg["num_hidden_layers"]):
        p = sub(params, f"layers.{i}.")
        h = rms_norm(x, p["input_layernorm.weight"], eps)
        attn = kda if i in linear else mla
        x = x + attn(sub(p, "self_attn."), cfg, h)
        h = rms_norm(x, p["post_attention_layernorm.weight"], eps)
        m = sub(p, "mlp.")
        if i >= cfg["first_k_dense_replace"]:
            x = x + moe(m, cfg, h)
        else:
            x = x + swiglu(h, m["gate_proj.weight"], m["up_proj.weight"],
                           m["down_proj.weight"])
    x = rms_norm(x, params["norm.weight"].float(), eps)
    return x @ params["lm_head.weight"].float().T
