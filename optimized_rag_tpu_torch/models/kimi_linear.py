"""Kimi Linear (Kimi-Linear-48B-A3B): Kimi Delta Attention (KDA) layers
beside NoPE MLA layers, over DeepSeek's mixture of experts, as the RAG
service's answer generator.

There is no counterpart in the JAX package. The equations follow the Kimi
Linear report (arXiv:2510.26692) and the layers of flash-linear-attention
that the published ``modeling_kimi.py`` uses
(huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct); the model is held
against the plain float32 reference ``tests/kimi_linear_reference.py`` (on
the CPU) and its copy for the card, ``portbench/reference/kimi_linear.py``.

Layers are pre-norm, ``x += Attn(RMSNorm(x)); x += FFN(RMSNorm(x))``; the
attention of layer i (1-based) is KDA where ``linear_attn_config`` lists i
under ``kda_layers`` (3 of every 4) and MLA where it lists it under
``full_attn_layers``. MLA, the router, the experts and the dense and shared
SwiGLUs are ``models/deepseek_v2.py``'s (``KimiLinearConfig.deepseek``):
MLA without RoPE (``mla_use_nope``; the ``qk_rope_head_dim`` values stay
and are cached unturned, the scale ``(d_n + d_r)^-0.5``), the sigmoid
router with its score-correction bias, renormalised and times
``routed_scaling_factor``.

* **KDA** (h heads of d = 128, D = h d). ``q, k, v = SiLU(ShortConv(W x))``,
  each a depthwise causal convolution of ``short_conv_kernel_size`` (4)
  taps without bias; ``q`` and ``k`` L2-normalised per head (eps 1e-6) and
  ``q`` times ``d^-0.5``; ``beta = sigmoid(W_b x)`` per head; the log-decay
  ``g = -exp(A_log) softplus(W_f_b W_f_a x + dt_bias)`` per channel (A_log
  per head, low rank d); per head the state S [d, d] in float32,
  ``S <- Diag(exp g_t) S``, ``S <- S + beta_t k_t (v_t - S^T k_t)^T``,
  ``o_t = S^T q_t``; the output ``W_o (RMSNorm_head(o) * sigmoid(W_g_b W_g_a
  x + b_g))``. Not confirmed from the published code here, and chosen: the
  output gate's up-projection has a bias (``g_b_proj.bias``), as
  flash-linear-attention's KDA layer has.
* **Prefill** runs the chunked form of ``ops/kda.py`` over chunks of 64
  tokens: the parts inside a chunk in torch over every chunk of the
  prefill chunk at once, the walk over chunks in ``csrc/kda_chunk.cu`` on
  the card (its twin on the CPU).
* **Decode** runs the recurrent step in torch, inside the decode step's
  CUDA graph, with the state and the convolutions' tails updated in place.
* **The hybrid cache** (``_HybridCache``) holds, for a call, the latent
  cache of the MLA layers [L_mla, B, S, r + d_r] (as
  ``models/deepseek_v2.py``'s), and for the KDA layers the state [L_kda,
  B, h, d, d] in float32 and the convolutions' tails, the last K - 1
  inputs of q, k and v side by side [L_kda, B, K - 1, 3 D]: a fixed size
  whatever the prompt length. A prefill segment that continues a row
  (``prefill_chunks``) starts from the row's carried state and tails; pad
  slots are never computed and never enter the state.
* **Routing kept** (``RouteLog``): with ``Generator.generate_ids``'s
  ``keep_logits``, the router ids those rows picked at every slot, for a
  check that routes its reference as the program routed.

Roundings: as ``models/deepseek_v2.py`` states for its parts. In KDA the
projections round to ``cfg.dtype``; the convolution sums its taps in
float32 and rounds, then SiLU rounds; everything after (the norms, beta,
g, the chunked form or the step, the output norm and gate) is float32 and
rounds once before ``W_o``. ``A_log``, ``dt_bias`` and the router's
``e_score_correction_bias`` are float32 parameters, as published.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from optimized_rag_tpu_torch.models import deepseek_v2 as ds
from optimized_rag_tpu_torch.ops import kda

# Keys of a published Kimi Linear ``config.json`` that this model supports
# with one value only.
_FIXED = {"q_lora_rank": None, "hidden_act": "silu",
          "tie_word_embeddings": False, "mla_use_nope": True,
          "moe_router_activation_func": "sigmoid", "moe_layer_freq": 1,
          "num_expert_group": 1, "topk_group": 1, "rope_scaling": None,
          "num_nextn_predict_layers": 0}
L2_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig:
    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kda_layers: tuple = tuple(i for i in range(27)
                              if i % 4 != 3 and i != 26)   # 0-based
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    short_conv_kernel_size: int = 4
    num_experts: int = 256             # the router's width
    num_experts_per_token: int = 8
    num_shared_experts: int = 1
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    moe_renormalize: bool = True
    rms_norm_eps: float = 1e-5
    model_max_length: int = 1048576
    expert_first: int = 0
    experts_held: Optional[int] = None  # None: all of them
    bos_token_id: int = 163584
    eos_token_id: int = 163585
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_config(cls, cfg: dict, **overrides) -> "KimiLinearConfig":
        """From the keys of a published ``config.json`` (unknown keys are
        ignored; a setting this model does not implement raises). Where
        ``cfg`` holds one rank's share of an expert-parallel deployment,
        ``expert_parallel: {"ranks": R, "rank": i}`` and ``num_experts``
        the experts a rank holds: the router is R times as wide, and this
        model holds ids ``i * num_experts`` on."""
        for key, want in _FIXED.items():
            if key in cfg and cfg[key] != want:
                raise ValueError(f"{key}={cfg[key]!r}: only {want!r} is "
                                 f"implemented")
        lac = cfg["linear_attn_config"]
        layers = cfg["num_hidden_layers"]
        kda_layers = sorted(i - 1 for i in lac["kda_layers"])
        full = sorted(i - 1 for i in lac["full_attn_layers"])
        if sorted(kda_layers + full) != list(range(layers)):
            raise ValueError("linear_attn_config: kda_layers and "
                             "full_attn_layers must split the layers")
        kw = {f.name: cfg[f.name] for f in dataclasses.fields(cls)
              if f.name in cfg and f.name not in ("dtype", "num_experts")}
        ep = cfg.get("expert_parallel") or {"ranks": 1, "rank": 0}
        ranks, rank = int(ep["ranks"]), int(ep["rank"])
        if not 0 <= rank < ranks:
            raise ValueError(f"expert_parallel rank {rank} of {ranks}")
        held = cfg["num_experts"]
        kw.update(kda_layers=tuple(kda_layers),
                  kda_num_heads=lac["num_heads"], kda_head_dim=lac["head_dim"],
                  short_conv_kernel_size=lac["short_conv_kernel_size"],
                  num_experts=held * ranks, expert_first=rank * held,
                  experts_held=held if ranks > 1 else None)
        kw.update(overrides)
        return cls(**kw)

    # What ``models/decoder.Generator`` reads of a configuration.
    @property
    def max_seq_len(self) -> int:
        return self.model_max_length

    @property
    def eos_id(self) -> int:
        return self.eos_token_id

    @property
    def pad_id(self) -> int:
        return self.eos_token_id

    byte_level = False

    @property
    def held(self) -> int:
        return (self.num_experts if self.experts_held is None
                else self.experts_held)

    @property
    def mla_layers(self) -> list[int]:
        return [i for i in range(self.num_hidden_layers)
                if i not in self.kda_layers]

    def deepseek(self) -> ds.DeepseekV2Config:
        """The configuration of the parts ``models/deepseek_v2.py``
        computes: MLA (NoPE, no YaRN), the router and experts, the dense
        and shared SwiGLUs."""
        return ds.DeepseekV2Config(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            moe_intermediate_size=self.moe_intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            n_routed_experts=self.num_experts,
            n_shared_experts=self.num_shared_experts,
            num_experts_per_tok=self.num_experts_per_token,
            first_k_dense_replace=self.first_k_dense_replace,
            kv_lora_rank=self.kv_lora_rank,
            qk_nope_head_dim=self.qk_nope_head_dim,
            qk_rope_head_dim=self.qk_rope_head_dim,
            v_head_dim=self.v_head_dim, rms_norm_eps=self.rms_norm_eps,
            rope_factor=1.0, max_position_embeddings=self.model_max_length,
            routed_scaling_factor=self.routed_scaling_factor,
            norm_topk_prob=self.moe_renormalize, scoring_func="sigmoid",
            mla_use_nope=True, expert_first=self.expert_first,
            experts_held=self.experts_held, bos_token_id=self.bos_token_id,
            eos_token_id=self.eos_token_id, dtype=self.dtype)

    def serving_model(self, params, seed: int, device) -> "KimiLinearLM":
        """As ``DeepseekV2Config.serving_model``."""
        return ds.serve(lambda: KimiLinearLM(self), params, seed, device)


# ---------------------------------------------------------------------------
# KDA
# ---------------------------------------------------------------------------

def l2norm(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


class ShortConv(nn.Module):
    """A depthwise causal convolution's weight [channels, 1, taps]."""

    def __init__(self, channels: int, taps: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, taps,
                                               dtype=dtype))
        nn.init.uniform_(self.weight, -taps ** -0.5, taps ** -0.5)


def causal_conv(x, weight):
    """SiLU of the depthwise convolution of rows ``x`` [L, D] by ``weight``
    [D, 1, K], without padding -> [L - K + 1, D]: the taps summed in
    float32, rounded to x's dtype, then SiLU (through a channels-last 2-d
    convolution, which reads the rows as they lie)."""
    d, _, taps = weight.shape
    xin = x.t()[None, :, None, :]
    y = F.conv2d(xin, weight.view(d, 1, 1, taps), groups=d)
    return F.silu(y[0, :, 0].t())


class _Plan:
    """The index maps one prefill chunk's KDA layers share. Each segment
    ``(row, first, a, e)`` of t tokens takes K - 1 + t rows of an extended
    layout: its convolution's K - 1 earlier inputs (the row's tail, or 0
    where the segment starts the row), then its tokens."""

    def __init__(self, segments, taps: int, device):
        p = taps - 1
        tok, out, pre, new = [], [], [], []
        self.rows, self.cont = [], []
        lengths, e0 = [], 0
        for row, first, a, e in segments:
            t = e - a
            tok += range(e0 + p, e0 + p + t)
            out += range(e0, e0 + t)
            new += range(e0 + t, e0 + t + p)
            if a > first:
                pre += range(e0, e0 + p)
                self.cont.append(row)
            self.rows.append(row)
            lengths.append(t)
            e0 += p + t
        self.ext_rows = e0
        self.slot, self.offsets, self.chunks = kda.layout(lengths, device)
        self.segments = len(segments)
        self.tok, self.out, self.pre, self.new, self.rows_t, self.cont_t = \
            _device_ints([tok, out, pre, new, self.rows, self.cont], device)


def _device_ints(lists, device):
    """Host int lists as int64 tensors on ``device``, in one copy."""
    flat = torch.tensor([v for x in lists for v in x], dtype=torch.long)
    if torch.device(device).type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    return list(flat.split([len(x) for x in lists]))


class KDA(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, dtype):
        super().__init__()
        h, n, d = cfg.hidden_size, cfg.kda_num_heads, cfg.kda_head_dim
        width, taps = n * d, cfg.short_conv_kernel_size
        self.heads, self.dim, self.taps = n, d, taps
        self.eps = cfg.rms_norm_eps
        self.q_proj = ds._linear(h, width, dtype)
        self.k_proj = ds._linear(h, width, dtype)
        self.v_proj = ds._linear(h, width, dtype)
        self.q_conv1d = ShortConv(width, taps, dtype)
        self.k_conv1d = ShortConv(width, taps, dtype)
        self.v_conv1d = ShortConv(width, taps, dtype)
        # flash-linear-attention's initialisation: A = U(1, 16) a head, and
        # dt_bias the inverse softplus of dt log-uniform on [0.001, 0.1].
        self.A_log = nn.Parameter(torch.empty(n, dtype=torch.float32
                                              ).uniform_(1, 16).log_())
        dt = torch.exp(torch.rand(width) * (math.log(0.1) - math.log(1e-3))
                       + math.log(1e-3)).clamp_min(1e-4)
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        self.f_a_proj = ds._linear(h, d, dtype)
        self.f_b_proj = ds._linear(d, width, dtype)
        self.b_proj = ds._linear(h, n, dtype)
        self.g_a_proj = ds._linear(h, d, dtype)
        self.g_b_proj = nn.Linear(d, width, bias=True, dtype=dtype)
        self.o_norm = ds.RMSNorm(d, cfg.rms_norm_eps, dtype)
        self.o_proj = ds._linear(width, h, dtype)

    def _convs(self):
        return ((self.q_proj, self.q_conv1d), (self.k_proj, self.k_conv1d),
                (self.v_proj, self.v_conv1d))

    def gate(self, h):
        """float32 log-decays [T, h, d] of normed rows h [T, H]."""
        f = self.f_b_proj(self.f_a_proj(h)).float() + self.dt_bias
        return F.softplus(f).unflatten(-1, (self.heads, self.dim)).mul_(
            -self.A_log.exp()[:, None])

    def beta(self, h):
        return self.b_proj(h).float().sigmoid()

    def out(self, o, h):
        """``W_o`` of the gated, per-head normed float32 output o [T, h,
        d]."""
        g = self.g_b_proj(self.g_a_proj(h)).float().sigmoid()
        y = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + self.eps)
        y = y * self.o_norm.weight.float() * g.unflatten(-1, y.shape[-2:])
        return self.o_proj(y.to(h.dtype).flatten(-2))

    def prefill(self, h, state, tail, plan: _Plan):
        """One prefill chunk's rows h [T, H] (``plan``'s segments): reads
        and writes each segment row's ``state`` [B, h, d, d] and ``tail``
        [B, K - 1, 3 D]."""
        n, d, taps = self.heads, self.dim, self.taps
        width = n * d
        ext = h.new_zeros(plan.ext_rows, h.shape[1])
        ext.index_copy_(0, plan.tok, h)
        act = []
        for j, (proj, conv) in enumerate(self._convs()):
            x = proj(ext)
            tj = tail[..., j * width:(j + 1) * width]
            if plan.cont:
                x.index_copy_(0, plan.pre, tj[plan.cont_t].flatten(0, 1))
            tj[plan.rows_t] = x[plan.new].view(plan.segments, taps - 1,
                                                width)
            y = causal_conv(x, conv.weight).index_select(0, plan.out)
            del x
            act.append(kda.pack(y, plan.slot, plan.chunks, n))
            del y
        del ext
        q, k, v = act
        del act
        m = plan.chunks * n
        q = l2norm(q).mul_(d ** -0.5).view(m, kda.CHUNK, d)
        k = l2norm(k).view(m, kda.CHUNK, d)
        g = kda.pack(self.gate(h).flatten(-2), plan.slot, plan.chunks, n)
        beta = kda.pack(self.beta(h), plan.slot, plan.chunks, n)
        parts = kda.chunk_tensors(q, k, v.view(m, kda.CHUNK, d),
                                  g.view(m, kda.CHUNK, d),
                                  beta.view(m, kda.CHUNK))
        del q, k, v, g, beta
        shape = (plan.chunks, n, kda.CHUNK)
        wu, qt, aqk, kh, gam = (parts[0].view(*shape, 2 * d),
                                parts[1].view(*shape, d),
                                parts[2].view(*shape, kda.CHUNK),
                                parts[3].view(*shape, d),
                                parts[4].view(plan.chunks, n, d))
        del parts
        o = kda.chunk_state(wu, qt, aqk, kh, gam, plan.offsets, plan.rows,
                            state)
        del wu, qt, aqk, kh, gam
        return self.out(kda.unpack(o, plan.slot), h)

    def decode(self, h, state, tail):
        """One step of every row: h [B, H]; updates ``state`` [B, h, d, d]
        and ``tail`` [B, K - 1, 3 D] in place."""
        n, d = self.heads, self.dim
        x = torch.cat([p(h) for p, _ in self._convs()], dim=-1)
        window = torch.cat([tail, x[:, None]], dim=1)           # [B, K, 3D]
        tail.copy_(window[:, 1:])
        w = torch.cat([c.weight for _, c in self._convs()])[:, 0]  # [3D, K]
        y = F.silu((window.float() * w.t().float()).sum(1).to(h.dtype))
        q, k, v = (t.float().unflatten(-1, (n, d)) for t in y.split(n * d,
                                                                     -1))
        q, k = l2norm(q).mul_(d ** -0.5), l2norm(k)
        state.mul_(self.gate(h).exp_()[..., None])
        kv = torch.matmul(k[..., None, :], state)[..., 0, :]
        delta = (v - kv).mul_(self.beta(h)[..., None])
        b = state.shape[0] * n
        state.view(b, d, d).baddbmm_(k.reshape(b, d, 1),
                                     delta.reshape(b, 1, d))
        o = torch.matmul(q[..., None, :], state)[..., 0, :]
        return self.out(o, h)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, dcfg: ds.DeepseekV2Config,
                 index: int, dtype):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = ds.RMSNorm(h, eps, dtype)
        self.self_attn = (KDA(cfg, dtype) if index in cfg.kda_layers
                          else ds.MLA(dcfg, dtype))
        self.post_attention_layernorm = ds.RMSNorm(h, eps, dtype)
        self.mlp = (ds.MoE(dcfg, dtype) if dcfg.is_moe(index)
                    else ds.MLP(h, cfg.intermediate_size, dtype))

    ffn = ds.Layer.ffn


class KimiLinearLM(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, param_dtype=None):
        super().__init__()
        dt = param_dtype or cfg.dtype
        dcfg = cfg.deepseek()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=dt)
        self.layers = nn.ModuleList(Layer(cfg, dcfg, i, dt)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = ds.RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dt)
        self.lm_head = ds._linear(cfg.hidden_size, cfg.vocab_size, dt)
        self._moe_index = {i: j for j, i in enumerate(dcfg.moe_layers)}
        self._kda_index = {i: j for j, i in enumerate(cfg.kda_layers)}
        self._mla_index = {i: j for j, i in enumerate(cfg.mla_layers)}

    keeps_routes = True     # prefill(..., keep=rows): ``RouteLog``
    dtype = ds.DeepseekV2LM.dtype
    head = ds.DeepseekV2LM.head
    _note = ds.DeepseekV2LM._note

    def new_cache(self, batch: int, slots: int, device) -> "_HybridCache":
        """The hybrid cache, zeroed (``_HybridCache``)."""
        c, kv = self.cfg, self.layers[self.cfg.kda_layers[0]].self_attn
        return _HybridCache(
            torch.zeros(len(self._mla_index), batch, slots,
                        c.kv_lora_rank + c.qk_rope_head_dim,
                        dtype=self.dtype, device=device),
            torch.zeros(len(self._kda_index), batch, kv.heads, kv.dim,
                        kv.dim, dtype=torch.float32, device=device),
            torch.zeros(len(self._kda_index), batch, kv.taps - 1,
                        3 * kv.heads * kv.dim, dtype=self.dtype,
                        device=device), 0)

    def _chunk(self, ids, cache, segments, probe=None):
        """The final hidden states [T, H] of one prefill chunk
        (``ds.MLA.prefill``'s ``segments``), written through every layer's
        part of ``cache``."""
        x = F.embedding(torch.cat([ids[r, a:e] for r, _, a, e in segments]),
                        self.embed_tokens.weight)
        plan = _Plan(segments, self.cfg.short_conv_kernel_size, ids.device)
        log = cache.routes and cache.routes.prefill(segments)
        for i, layer in enumerate(self.layers):
            h = layer.input_layernorm(x)
            if i in self._kda_index:
                j = self._kda_index[i]
                x = x + layer.self_attn.prefill(h, cache.state[j],
                                                cache.tail[j], plan)
                if probe is not None:
                    probe.kda(plan.chunks)
            else:
                x = x + layer.self_attn.prefill(
                    h, cache.buf[self._mla_index[i]], segments, None, None)
            del h
            x = layer.ffn(x, _both(self._note(probe, i),
                                   log and log(self._moe_index.get(i))))
        if probe is not None:
            probe.chunk(x.shape[0])
        return x

    def forward(self, ids, chunk: Optional[int] = None):
        """One unpadded sequence ``ids`` [L] -> float32 logits [L, V]
        (prefill in chunks of ``chunk`` positions into a scratch cache)."""
        length = ids.shape[0]
        cache = self.new_cache(1, length, ids.device)
        return self.head(torch.cat([
            self._chunk(ids[None], cache, segs)
            for segs in ds.prefill_chunks([0], length, chunk or length)]))

    def prefill(self, ids, pad_len, pad_mask, pos_ids, total: int,
                chunk: Optional[int] = None, probe=None, keep=None):
        """As ``DeepseekV2LM.prefill``, into the hybrid cache; with ``keep``
        (row indices) the cache keeps those rows' routing
        (``RouteLog``)."""
        b, p = ids.shape
        pads = [int(x) for x in pad_len.tolist()]
        cache = self.new_cache(b, total, ids.device)
        if keep is not None:
            cache.routes = RouteLog(
                keep, len(self._moe_index), total,
                self.cfg.num_experts_per_token, ids.device)
        last = [None] * b
        for segs in ds.prefill_chunks(pads, p, chunk or p):
            x = self._chunk(ids, cache, segs, probe)
            off = 0
            for r, _, a, e in segs:
                off += e - a
                if e == p:
                    last[r] = x[off - 1]
        cache.lo = min(pads) // 8 * 8
        return self.head(torch.stack(last)), cache

    def decode(self, toks, slot: int, cache: "_HybridCache", storage_valid,
               pos_ids, probe=None):
        """As ``DeepseekV2LM.decode`` (no position is read: NoPE)."""
        if cache.step is None:
            cache.step = _Step(self, cache, storage_valid, probe is not None)
        out = cache.step(toks, slot, pos_ids)
        if probe is not None:
            probe.step_hits(cache.step.hit)
        return out


class _Step(ds._DecodeStep):
    """``ds._DecodeStep`` through the hybrid cache: the KDA layers update
    their state and tails in place, the MLA layers attend, absorbed, over
    their latent cache."""

    def __init__(self, model, cache, storage_valid, count: bool):
        super().__init__(model, cache, storage_valid, count)
        self.cache = cache

    def _run(self):
        m, c = self.model, self.cache
        x = F.embedding(self.toks, m.embed_tokens.weight)
        valid = self.storage_valid & (self.cols <= self.slot)
        log = c.routes and c.routes.step(self.slot)
        for i, layer in enumerate(m.layers):
            h = layer.input_layernorm(x)
            if i in m._kda_index:
                j = m._kda_index[i]
                x = x + layer.self_attn.decode(h, c.state[j], c.tail[j])
            else:
                x = x + layer.self_attn.decode(
                    h, c.buf[m._mla_index[i]], self.slot, self.lo, valid,
                    None, None)
            x = layer.ffn(x, _both(self._note(i),
                                   log and log(m._moe_index.get(i))))
        return m.head(x)


@dataclasses.dataclass
class _HybridCache:
    buf: torch.Tensor       # [MLA layers, B, S, r + d_r]: the latent cache
    state: torch.Tensor     # [KDA layers, B, h, d, d] float32
    tail: torch.Tensor      # [KDA layers, B, K - 1, 3 D]: q, k, v inputs
    lo: int                 # the first slot decode reads: a multiple of 8
                            # at or below any row's first real slot
    step: Optional[_Step] = None
    routes: Optional["RouteLog"] = None

    def byte_sizes(self) -> dict:
        return {"latent_bytes": self.buf.nbytes,
                "state_bytes": self.state.nbytes + self.tail.nbytes}


def _both(a, b):
    """One ``note(idx)`` that calls ``a`` and ``b``, either may be None."""
    if a is None or b is None:
        return a or b
    return lambda idx: (a(idx), b(idx))


class RouteLog:
    """The router ids [MoE layers, len(rows), S, k] (int16, -1 where no
    token ran) that the kept ``rows`` of a call picked at each slot of the
    S, prefill and decode: what a check needs to route its reference as
    the program routed, so that a near-tie the program's rounding decided
    the other way does not carry through the later layers."""

    def __init__(self, rows, layers: int, slots: int, k: int, device):
        self.rows = [int(r) for r in rows]
        self.slots = slots
        self.ids = torch.full((layers, len(self.rows), slots, k), -1,
                              dtype=torch.int16, device=device)
        self.device = torch.device(device)
        self.kept = torch.tensor(self.rows, device=device)

    def _writer(self, src, dst):
        """``layer -> log(idx)``: the ids of tokens ``src`` into flat slots
        ``dst`` of that layer (None off the MoE layers)."""
        def at(layer):
            if layer is None:
                return None
            out = self.ids[layer].view(-1, self.ids.shape[-1])
            return lambda idx: out.index_copy_(0, dst, idx[src].to(out.dtype))
        return at

    def prefill(self, segments):
        """The writer of a prefill chunk of ``segments`` (None where no
        kept row has a token in it)."""
        src, dst, off = [], [], 0
        for r, _, a, e in segments:
            if r in self.rows:
                j = self.rows.index(r)
                src += range(off, off + e - a)
                dst += range(j * self.slots + a, j * self.slots + e)
            off += e - a
        if not src:
            return None
        src, dst = _device_ints([src, dst], self.device)
        return self._writer(src, dst)

    def step(self, slot):
        """The writer of a decode step at device slot ``slot`` [1] (kept
        on the device, as a CUDA graph replays it)."""
        return self._writer(self.kept, torch.arange(
            len(self.rows), device=self.device) * self.slots + slot)
