"""DeepSeek-V2's forward pass in float32 for the check on the card.

The equations of ``tests/deepseek_v2_reference.py``, which the CPU tests
hold the program to (``modeling_deepseek.py`` of
huggingface.co/deepseek-ai/DeepSeek-V2-Lite, configured by the keys of its
``config.json``), computed layer by layer over every sequence at once and
in blocks of queries, so that the whole model at its published widths fits
on the card beside nothing else once the program has closed: one layer's
weights at a time, in float32, drawn again through ``weight(name)``. It
imports nothing of the program; matmuls run in float32 with TF32 off.

Departures from the published code, none of them in the function: all
float32; cos and sin of RoPE float32; the routed experts stacked
(``mlp.experts.gate_up_proj`` [E, 2 I, H], each expert's gate rows then its
up rows, and ``mlp.experts.down_proj`` [E, H, I]); the experts' tokens
gathered by expert as ``moe_infer`` does.

``matmul_dtype=torch.float8_e4m3fn`` is the control: each matmul's two
inputs rounded to fp8 (per-tensor scale, amax to 448) before a float32
product, the step below the bfloat16 the configuration states.
"""

from __future__ import annotations

import math

import torch

_FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def is_moe(cfg: dict, layer: int) -> bool:
    return (cfg["n_routed_experts"] is not None
            and layer >= cfg["first_k_dense_replace"]
            and layer % cfg["moe_layer_freq"] == 0)


def param_shapes(cfg: dict) -> dict:
    """Every tensor of the model by name, with its shape."""
    h, n = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, v = cfg["kv_lora_rank"], cfg["vocab_size"]
    out = {"embed_tokens.weight": (v, h)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out.update({
            p + "input_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (n * (dn + dr), h),
            p + "self_attn.kv_a_proj_with_mqa.weight": (r + dr, h),
            p + "self_attn.kv_a_layernorm.weight": (r,),
            p + "self_attn.kv_b_proj.weight": (n * (dn + dv), r),
            p + "self_attn.o_proj.weight": (h, n * dv),
            p + "post_attention_layernorm.weight": (h,)})
        if is_moe(cfg, i):
            e, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
            s = w * cfg["n_shared_experts"]
            out.update({
                p + "mlp.gate.weight": (e, h),
                p + "mlp.experts.gate_up_proj": (e, 2 * w, h),
                p + "mlp.experts.down_proj": (e, h, w),
                p + "mlp.shared_experts.gate_proj.weight": (s, h),
                p + "mlp.shared_experts.up_proj.weight": (s, h),
                p + "mlp.shared_experts.down_proj.weight": (h, s)})
        else:
            w = cfg["intermediate_size"]
            out.update({p + "mlp.gate_proj.weight": (w, h),
                        p + "mlp.up_proj.weight": (w, h),
                        p + "mlp.down_proj.weight": (h, w)})
    out["norm.weight"] = (h,)
    out["lm_head.weight"] = (v, h)
    return out


def _mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_tables(cfg: dict, length: int, device):
    """YaRN cos and sin [length, d_r], float32."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra, inter = 1.0 / base ** exps, 1.0 / (factor * base ** exps)

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    inv = inter * ramp + extra * (1 - ramp)
    freqs = torch.outer(torch.arange(length, dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    m = _mscale(factor, rs["mscale"]) / _mscale(factor, rs["mscale_all_dim"])
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


def softmax_scale(cfg: dict) -> float:
    m = _mscale(cfg["rope_scaling"]["factor"],
                cfg["rope_scaling"]["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def _rotary(x, cos, sin):
    """x [..., L, d]: interleaved pairs into halves, then RoPE."""
    *lead, d = x.shape
    x = x.view(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


class Reference:
    """``weight(name)`` gives a tensor of the model (any dtype, on
    ``device``), drawn again at each call."""

    def __init__(self, cfg: dict, weight, device,
                 matmul_dtype=torch.float32, block: int = 512):
        self.cfg = cfg
        self.weight = weight
        self.device = torch.device(device)
        self.fp8 = matmul_dtype == torch.float8_e4m3fn
        self.block = block

    def _mm(self, a, b):
        """a @ b.T in float32 (inputs in fp8 for the control)."""
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return a @ b.transpose(-1, -2)

    def _w(self, name):
        return self.weight(name).float()

    def _norm(self, x, name):
        var = x.pow(2).mean(-1, keepdim=True)
        return self._w(name) * (x * torch.rsqrt(var + self.cfg[
            "rms_norm_eps"]))

    def _swiglu(self, x, gate, up, down):
        return self._mm(torch.nn.functional.silu(self._mm(x, gate))
                        * self._mm(x, up), down)

    def _attention(self, p, x, cos, sin):
        c = self.cfg
        n = c["num_attention_heads"]
        dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
        r, length = c["kv_lora_rank"], x.shape[0]
        q = self._mm(x, self._w(p + "q_proj.weight")).view(
            length, n, dn + dr).transpose(0, 1)
        ckv = self._mm(x, self._w(p + "kv_a_proj_with_mqa.weight"))
        lat = self._norm(ckv[:, :r], p + "kv_a_layernorm.weight")
        kv = self._mm(lat, self._w(p + "kv_b_proj.weight")).view(
            length, n, dn + dv).transpose(0, 1)
        del lat
        cos, sin = cos[:length], sin[:length]
        qs = torch.cat([q[..., :dn], _rotary(q[..., dn:], cos, sin)], -1)
        k_pe = _rotary(ckv[None, :, r:], cos, sin)
        ks = torch.cat([kv[..., :dn], k_pe.expand(n, -1, -1)], dim=-1)
        v = kv[..., dn:]
        del q, kv
        scale = softmax_scale(c)
        out = torch.empty(n, length, dv, device=x.device)
        for a in range(0, length, self.block):
            b = min(a + self.block, length)
            s = self._mm(qs[:, a:b], ks[:, :b]) * scale
            mask = (torch.arange(b, device=x.device)[None]
                    <= torch.arange(a, b, device=x.device)[:, None])
            w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            out[:, a:b] = self._mm(w, v[:, :b].transpose(1, 2))
        o = out.transpose(0, 1).reshape(length, n * dv)
        return self._mm(o, self._w(p + "o_proj.weight"))

    def _moe(self, p, x):
        c = self.cfg
        logits = self._mm(x, self._w(p + "gate.weight"))
        w, idx = torch.topk(torch.softmax(logits, dim=-1),
                            c["num_experts_per_tok"], dim=-1)
        if c["norm_topk_prob"]:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        else:
            w = w * c["routed_scaling_factor"]
        width = c["moe_intermediate_size"]
        gu = self._w(p + "experts.gate_up_proj")
        down = self._w(p + "experts.down_proj")
        out = torch.zeros_like(x)
        for e in range(c["n_routed_experts"]):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel():
                y = self._swiglu(x[tok], gu[e, :width], gu[e, width:],
                                 down[e])
                out.index_add_(0, tok, y * w[tok, slot, None])
        del gu, down
        return out + self._swiglu(
            x, self._w(p + "shared_experts.gate_proj.weight"),
            self._w(p + "shared_experts.up_proj.weight"),
            self._w(p + "shared_experts.down_proj.weight"))

    @torch.no_grad()
    def logits(self, seqs: list, positions: list) -> list:
        """float32 logits [len(pos), V] of each sequence of ids at its
        ``positions`` (the logits after each of those positions)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c = self.cfg
        emb = self.weight("embed_tokens.weight")
        xs = [emb[s.to(self.device)].float() for s in seqs]
        del emb
        cos, sin = rope_tables(c, max(s.shape[0] for s in seqs), self.device)
        for i in range(c["num_hidden_layers"]):
            p = f"layers.{i}."
            for j, x in enumerate(xs):
                x = x + self._attention(p + "self_attn.",
                                        self._norm(x, p + "input_layernorm"
                                                   ".weight"), cos, sin)
                h = self._norm(x, p + "post_attention_layernorm.weight")
                if is_moe(c, i):
                    x = x + self._moe(p + "mlp.", h)
                else:
                    x = x + self._swiglu(
                        h, self._w(p + "mlp.gate_proj.weight"),
                        self._w(p + "mlp.up_proj.weight"),
                        self._w(p + "mlp.down_proj.weight"))
                xs[j] = x
        head = self._w("lm_head.weight")
        return [self._mm(self._norm(x[torch.as_tensor(pos).to(self.device)],
                                    "norm.weight"), head)
                for x, pos in zip(xs, positions)]
