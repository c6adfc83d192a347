"""Kimi Linear's forward pass in float32 for the check on the card.

The equations of ``tests/kimi_linear_reference.py``, which the CPU tests
hold the program to (the Kimi Linear report, arXiv:2510.26692, and the
published ``modeling_kimi.py`` of
huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct, configured by the
keys of its ``config.json``), computed layer by layer over every sequence
and so that the whole model at its published widths fits on the card
beside nothing else once the program has closed: one layer's weights at a
time, in float32, drawn again through ``weight(name)``. It imports nothing
of the program; matmuls run in float32 with TF32 off.

* MLA (NoPE) expanded, in blocks of queries.
* KDA in the chunked form with pairwise decays: for each chunk of 64
  tokens the decay of every pair (r, s), s <= r, as ``exp(G_r - G_s)``
  [C, C, d] (``G`` the cumulative log-decay), the triangular solve, then
  the chunks in order from the state (``kda_chunked``). It is held on the
  CPU against the token recurrence in float64.
* The MoE holds the configuration's share: ``num_experts`` experts, ids
  ``rank * num_experts`` on, of a router over ``ranks * num_experts``
  (``expert_parallel``); a pick of an absent expert adds nothing.
* Routing: by its own top k, or by the ids it is given (``logits``'s
  ``routes``: the program's), weighted by its own scores at those ids.
  With given ids it measures each token's ``gap`` in each MoE layer: the
  amount by which its own k-th best biased score lies above its biased
  score of the worst given pick (0 where the given picks are its own top
  k).

Departures from the published code, none of them in the function: all
float32; the routed experts stacked (``mlp.experts.gate_up_proj`` [E, 2 I,
H] and ``mlp.experts.down_proj`` [E, H, I]), their tokens gathered by
expert.

``matmul_dtype=torch.float8_e4m3fn`` is the control: each matmul with a
weight has its two inputs rounded to fp8 (per-tensor scale, amax to 448)
before a float32 product, the step below the bfloat16 the configuration
states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_FP8_MAX = 448.0
CHUNK = 64


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def kda_layers(cfg: dict) -> set:
    return {i - 1 for i in cfg["linear_attn_config"]["kda_layers"]}


def share(cfg: dict) -> tuple[int, int, int]:
    """(first held id, experts held, the router's width)."""
    ep = cfg.get("expert_parallel") or {"ranks": 1, "rank": 0}
    held = cfg["num_experts"]
    return ep["rank"] * held, held, ep["ranks"] * held


def param_shapes(cfg: dict) -> dict:
    """Every tensor of the model (this share of it) by name, with its
    shape."""
    h, n = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, v = cfg["kv_lora_rank"], cfg["vocab_size"]
    lac = cfg["linear_attn_config"]
    kn, kd, taps = (lac["num_heads"], lac["head_dim"],
                    lac["short_conv_kernel_size"])
    width = kn * kd
    _, held, total = share(cfg)
    linear = kda_layers(cfg)
    out = {"embed_tokens.weight": (v, h)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        a = p + "self_attn."
        out[p + "input_layernorm.weight"] = (h,)
        if i in linear:
            for x in "qkv":
                out[a + f"{x}_proj.weight"] = (width, h)
                out[a + f"{x}_conv1d.weight"] = (width, 1, taps)
            out.update({
                a + "A_log": (kn,), a + "dt_bias": (width,),
                a + "f_a_proj.weight": (kd, h),
                a + "f_b_proj.weight": (width, kd),
                a + "b_proj.weight": (kn, h),
                a + "g_a_proj.weight": (kd, h),
                a + "g_b_proj.weight": (width, kd),
                a + "g_b_proj.bias": (width,),
                a + "o_norm.weight": (kd,),
                a + "o_proj.weight": (h, width)})
        else:
            out.update({
                a + "q_proj.weight": (n * (dn + dr), h),
                a + "kv_a_proj_with_mqa.weight": (r + dr, h),
                a + "kv_a_layernorm.weight": (r,),
                a + "kv_b_proj.weight": (n * (dn + dv), r),
                a + "o_proj.weight": (h, n * dv)})
        out[p + "post_attention_layernorm.weight"] = (h,)
        if i >= cfg["first_k_dense_replace"]:
            w = cfg["moe_intermediate_size"]
            s = w * cfg["num_shared_experts"]
            out.update({
                p + "mlp.gate.weight": (total, h),
                p + "mlp.gate.e_score_correction_bias": (total,),
                p + "mlp.experts.gate_up_proj": (held, 2 * w, h),
                p + "mlp.experts.down_proj": (held, h, w),
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


def pair_decays(G):
    """exp(G_r - G_s) for s <= r, else 0: [..., C, C, d] of cumulative
    log-decays G [..., C, d]."""
    c = G.shape[-2]
    diff = G[..., :, None, :] - G[..., None, :, :]
    keep = torch.ones(c, c, dtype=torch.bool, device=G.device).tril()
    return diff.masked_fill_(~keep[..., None], float("-inf")).exp_()


def kda_chunked(q, k, v, g, beta, state=None, chunks_at_once: int = 8):
    """The gated delta rule in chunks of 64: q, k, g [L, h, d_k], v [L, h,
    d_v], beta [L, h] -> (o [L, h, d_v], the final state [h, d_k, d_v])."""
    length, n, dk = k.shape
    dv = v.shape[-1]
    nc = -(-length // CHUNK)
    pad = nc * CHUNK - length

    def chunked(x):
        """[L, h, d] -> [h, chunks, C, d], the pad positions 0."""
        return F.pad(x, (0, 0, 0, 0, 0, pad)).view(
            nc, CHUNK, n, -1).permute(2, 0, 1, 3)
    q, k, v, g = map(chunked, (q, k, v, g))
    beta = chunked(beta[..., None])[..., 0]
    s = q.new_zeros(n, dk, dv) if state is None else state
    eye = torch.eye(CHUNK, dtype=q.dtype, device=q.device)
    strict = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                        device=q.device).tril(-1)
    out = q.new_empty(n, nc, CHUNK, dv)
    for a in range(0, nc, chunks_at_once):
        b = min(a + chunks_at_once, nc)
        G = g[:, a:b].cumsum(-2)                         # [h, c, C, d]
        dec = pair_decays(G)                             # [h, c, C, C, d]
        akk = torch.einsum("hcrd,hcsd,hcrsd->hcrs", k[:, a:b], k[:, a:b],
                           dec).masked_fill_(~strict, 0)
        aqk = torch.einsum("hcrd,hcsd,hcrsd->hcrs", q[:, a:b], k[:, a:b],
                           dec)
        del dec
        bt = beta[:, a:b, :, None]
        rhs = torch.cat([k[:, a:b] * G.exp(), v[:, a:b]], -1) * bt
        wu = torch.linalg.solve_triangular(eye + bt * akk, rhs, upper=False)
        w, u = wu[..., :dk], wu[..., dk:]
        qt = q[:, a:b] * G.exp()
        kh = k[:, a:b] * (G[:, :, -1:] - G).exp()
        gam = G[:, :, -1].exp()
        for c in range(b - a):
            uc = u[:, c] - w[:, c] @ s
            out[:, a + c] = qt[:, c] @ s + aqk[:, c] @ uc
            s = gam[:, c, :, None] * s + kh[:, c].transpose(-1, -2) @ uc
    return out.permute(1, 2, 0, 3).reshape(nc * CHUNK, n, dv)[:length], s


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
        return self._mm(F.silu(self._mm(x, gate)) * self._mm(x, up), down)

    def _mla(self, p, x):
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
        ks = torch.cat([kv[..., :dn], ckv[None, :, r:].expand(n, -1, -1)],
                       dim=-1)
        v = kv[..., dn:]
        scale = (dn + dr) ** -0.5
        out = torch.empty(n, length, dv, device=x.device)
        for a in range(0, length, self.block):
            b = min(a + self.block, length)
            s = self._mm(q[:, a:b], ks[:, :b]) * scale
            mask = (torch.arange(b, device=x.device)[None]
                    <= torch.arange(a, b, device=x.device)[:, None])
            w = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            out[:, a:b] = self._mm(w, v[:, :b].transpose(1, 2))
        o = out.transpose(0, 1).reshape(length, n * dv)
        return self._mm(o, self._w(p + "o_proj.weight"))

    def _kda(self, p, x):
        lac = self.cfg["linear_attn_config"]
        n, d, length = lac["num_heads"], lac["head_dim"], x.shape[0]
        taps = lac["short_conv_kernel_size"]

        def conv(a):
            y = self._mm(x, self._w(p + f"{a}_proj.weight"))
            w = self._w(p + f"{a}_conv1d.weight")[:, 0]
            y = F.pad(y, (0, 0, taps - 1, 0))
            return F.silu(sum(y[j:j + length] * w[:, j]
                              for j in range(taps))).view(length, n, d)
        q, k, v = conv("q"), conv("k"), conv("v")
        q = q * torch.rsqrt(q.pow(2).sum(-1, keepdim=True) + 1e-6) \
            * d ** -0.5
        k = k * torch.rsqrt(k.pow(2).sum(-1, keepdim=True) + 1e-6)
        beta = torch.sigmoid(self._mm(x, self._w(p + "b_proj.weight")))
        f = self._mm(self._mm(x, self._w(p + "f_a_proj.weight")),
                     self._w(p + "f_b_proj.weight"))
        g = (-self._w(p + "A_log").exp()[:, None]
             * F.softplus(f + self._w(p + "dt_bias")).view(length, n, d))
        del f
        o, _ = kda_chunked(q, k, v, g, beta)
        del q, k, v, g
        gate = torch.sigmoid(self._mm(self._mm(
            x, self._w(p + "g_a_proj.weight")), self._w(p + "g_b_proj.weight"))
            + self._w(p + "g_b_proj.bias")).view(length, n, d)
        o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True)
                            + self.cfg["rms_norm_eps"])
        o = o * self._w(p + "o_norm.weight") * gate
        return self._mm(o.reshape(length, n * d), self._w(p + "o_proj.weight"))

    def _moe(self, p, x, given=None):
        """(the layer's output, the ids it routed by, the gaps of
        ``given`` ids [T, k] (None without them))."""
        c = self.cfg
        scores = torch.sigmoid(self._mm(x, self._w(p + "gate.weight")))
        biased = scores + self._w(p + "gate.e_score_correction_bias")
        own = torch.topk(biased, c["num_experts_per_token"], dim=-1)
        idx, gap = own.indices, None
        if given is not None:
            idx = given.to(self.device).long()
            gap = (own.values[:, -1] - biased.gather(1, idx).amin(1)
                   ).clamp_min(0)
        w = scores.gather(1, idx)
        if c["moe_renormalize"]:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        w = w * c["routed_scaling_factor"]
        first, held, _ = share(c)
        width = c["moe_intermediate_size"]
        gu = self._w(p + "experts.gate_up_proj")
        down = self._w(p + "experts.down_proj")
        out = torch.zeros_like(x)
        for e in range(held):
            tok, slot = torch.nonzero(idx == first + e, as_tuple=True)
            if tok.numel():
                y = self._swiglu(x[tok], gu[e, :width], gu[e, width:],
                                 down[e])
                out.index_add_(0, tok, y * w[tok, slot, None])
        del gu, down
        return out + self._swiglu(
            x, self._w(p + "shared_experts.gate_proj.weight"),
            self._w(p + "shared_experts.up_proj.weight"),
            self._w(p + "shared_experts.down_proj.weight")), idx, gap

    @torch.no_grad()
    def logits(self, seqs: list, positions: list, routes=None) -> list:
        """float32 logits [len(pos), V] of each sequence of ids at its
        ``positions`` (the logits after each of those positions). With
        ``routes``, each sequence's router ids [MoE layers, len, k], the
        MoE layers route by them. Then ``self.routes`` holds the ids each
        sequence routed by ([MoE layers, len, k], int16 on the host) and,
        with ``routes``, ``self.gaps`` the given ids' gaps [MoE layers,
        len]."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c = self.cfg
        linear = kda_layers(c)
        emb = self.weight("embed_tokens.weight")
        xs = [emb[s.to(self.device)].float() for s in seqs]
        del emb
        moe = [[] for _ in seqs]
        for i in range(c["num_hidden_layers"]):
            p = f"layers.{i}."
            for j, x in enumerate(xs):
                attn = self._kda if i in linear else self._mla
                x = x + attn(p + "self_attn.", self._norm(
                    x, p + "input_layernorm.weight"))
                h = self._norm(x, p + "post_attention_layernorm.weight")
                if i >= c["first_k_dense_replace"]:
                    given = (None if routes is None
                             else routes[j][len(moe[j])])
                    y, idx, gap = self._moe(p + "mlp.", h, given)
                    moe[j].append((idx.to(torch.int16).cpu(), gap))
                    x = x + y
                    del y
                else:
                    x = x + self._swiglu(
                        h, self._w(p + "mlp.gate_proj.weight"),
                        self._w(p + "mlp.up_proj.weight"),
                        self._w(p + "mlp.down_proj.weight"))
                xs[j] = x
        self.routes = [torch.stack([r for r, _ in m]) for m in moe]
        if routes is not None:
            self.gaps = [torch.stack([g for _, g in m]).cpu() for m in moe]
        head = self._w("lm_head.weight")
        return [self._mm(self._norm(x[torch.as_tensor(pos).to(self.device)],
                                    "norm.weight"), head)
                for x, pos in zip(xs, positions)]
