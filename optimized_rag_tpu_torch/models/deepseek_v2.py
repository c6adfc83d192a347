"""DeepSeek-V2 (-Lite): multi-head latent attention (MLA) with a latent
cache, and a mixture of experts, as the RAG service's answer generator.

There is no counterpart in the JAX package. The layer equations follow
``modeling_deepseek.py`` in the model's public repository
(huggingface.co/deepseek-ai/DeepSeek-V2-Lite); the model is held against the
plain float32 reference ``tests/deepseek_v2_reference.py`` (on the CPU) and
its copy for the card, ``portbench/reference/deepseek_v2.py``.

With ``n`` heads, hidden size ``H``, ``d_n`` = ``qk_nope_head_dim`` (128),
``d_r`` = ``qk_rope_head_dim`` (64), ``d_v`` = ``v_head_dim`` (128) and
``r`` = ``kv_lora_rank`` (512), a layer is pre-norm:
``x += MLA(RMSNorm(x)); x += FFN(RMSNorm(x))``, and the model is
``logits = W_head RMSNorm(x_L)`` over ``x_0 = embed(ids)``.

* **MLA** (``q_lora_rank`` null). ``q = W_q x`` splits into ``q_nope``
  [n x d_n] and ``q_pe`` [n x d_r]. ``[c; k_pe] = W_kv_a x``, then
  ``c = RMSNorm(c)`` [r] and ``[k_nope; v] = W_kv_b c`` [n x (d_n + d_v)].
  RoPE turns ``q_pe`` and the one ``k_pe`` that every head shares, after
  DeepSeek's permutation of interleaved pairs into halves
  (``x.view(d/2, 2).transpose``), then ``x cos + rotate_half(x) sin``. The
  score of query i and key j is ``(q_nope . k_nope + q_pe . k_pe) s`` with
  ``s = (d_n + d_r)^-0.5 m^2`` and ``m = 0.1 mscale_all_dim ln(factor) +
  1``; a causal softmax over them weighs ``v``, and the heads' outputs
  feed ``W_o``.
* **The cache.** For each token and layer the cache holds ``c`` (after its
  norm, r = 512) and ``k_pe`` (after RoPE, d_r = 64) side by side, in the
  model dtype: 576 values where full keys and values would take
  n (d_n + d_r + d_v) = 5,120.
* **Prefill** expands the latent: ``[k_nope; v] = W_kv_b c`` over every
  cached position of the row, then attention in the form above
  (``scaled_dot_product_attention``, causal; a fused kernel on the card,
  never a [P, P] score matrix).
* **Decode** computes the same function absorbed: with ``W_kv_b`` split by
  head into ``W_UK,h`` [d_n x r] and ``W_UV,h`` [d_v x r],
  ``q_lat,h = W_UK,h^T q_nope,h``; scores ``(q_lat . c + q_pe . k_pe) s``
  straight over the cache; ``o_h = W_UV,h (softmax . c)``.
* **YaRN.** Frequencies ``theta^(-2i/d_r)`` (extrapolated) and the same
  over ``factor`` (interpolated) are blended by a linear ramp over
  ``[low, high]``, the correction range of ``beta_fast`` and
  ``beta_slow`` rotations over ``original_max_position_embeddings``:
  ``inv_freq = interp (1 - mask) + extra mask``, ``mask = 1 - ramp``.
  cos and sin are scaled by ``m(factor, mscale) / m(factor,
  mscale_all_dim)``, exactly 1 with the published values.
* **MoE.** Router logits ``x W_g^T`` in float32, softmax, greedy top-k
  (k = 6 of 64), the weights not renormalised (``norm_topk_prob`` false)
  and times ``routed_scaling_factor`` (1). With ``scoring_func`` "sigmoid"
  (Kimi Linear, ``models/kimi_linear.py``) the scores are ``sigmoid(x
  W_g^T)``, the top k are picked on ``scores + e_score_correction_bias``,
  and the weights are the unbiased scores at those ids, divided by their
  sum where ``norm_topk_prob`` holds, then times ``routed_scaling_factor``.
  The output is
  ``sum_i p_i E_i(x) + S(x)``: each expert a SwiGLU
  ``W_down (silu(W_gate x) * W_up x)`` of width ``moe_intermediate_size``,
  ``S`` the shared experts as one SwiGLU of width ``n_shared_experts *
  moe_intermediate_size``. Layers before ``first_k_dense_replace`` are a
  dense SwiGLU of width ``intermediate_size``.
* **An expert-parallel share.** A layer may hold ``experts_held`` of the
  router's ``n_routed_experts``, ids from ``expert_first`` on: one rank's
  experts. It routes over all of them and computes only its own experts'
  part for the tokens routed to them; a pick of an absent expert adds
  nothing (its rank's part, with no exchange on one card). The shared
  experts and everything outside the MoE are whole.
* **NoPE** (``mla_use_nope``): RoPE is left out; the ``d_r`` values of
  ``q_pe`` and ``k_pe`` stay, and ``k_pe`` is cached unturned.

Roundings, as the published code has them but for the two noted: weights,
activations and the residual stream are in ``cfg.dtype`` (bfloat16); every
matmul rounds its output to it. RMSNorm (eps ``rms_norm_eps``) runs in
float32 and rounds once after its weight (the published code rounds before
the weight too). RoPE runs in float32 with float32 cos and sin and rounds
once (the published code rounds cos and sin to the dtype and multiplies
there). The router's logits, softmax and combine weights are float32; each
expert's output is cast to float32, weighted and summed there, then
rounded, as ``moe_infer`` does. Prefill attention: the fused kernel's
float32 scores and softmax. Decode attention: ``q_lat`` rounded to the
dtype, the score product in the dtype, then float32 times ``s``, mask and
softmax, the weights cast back to the dtype (as ``models/decoder.attend``).
The final norm stays float32 and the head runs in float32 over the bf16
head weight cast up: the logits are float32 throughout.

Experts live stacked, the layout the grouped path reads:
``mlp.experts.gate_up_proj`` [E, 2 I, H] (each expert's gate rows, then its
up rows) and ``mlp.experts.down_proj`` [E, H, I]. Where a forward has more
tokens than ``ALL_EXPERTS_MAX_TOKENS``, routed tokens are sorted by expert
and each expert runs one GEMM over its own (the counts are read once a
layer); at or under it (a decode step) every expert runs over every token
in three batched GEMMs and the combine weights are zero off the top k:
below the card's ridge a GEMM of so few rows costs the reading of its
weights, which the batch's picks touch nearly all of anyway, and the
launches and the wait for the counts are saved.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# A token count at or under which every routed expert runs over every token
# (module docstring): 989 TFLOP/s over 3.35 TB/s makes a bf16 GEMM of fewer
# than about 147 rows bound by reading its weights.
ALL_EXPERTS_MAX_TOKENS = 128
MASKED = -1e30

# Keys of a published DeepSeek-V2 ``config.json`` that this model supports
# with one value only.
_FIXED = {"q_lora_rank": None, "topk_method": "greedy",
          "scoring_func": "softmax", "hidden_act": "silu",
          "attention_bias": False, "tie_word_embeddings": False,
          "n_group": 1, "topk_group": 1}


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    max_position_embeddings: int = 163840
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    scoring_func: str = "softmax"
    mla_use_nope: bool = False
    expert_first: int = 0
    experts_held: Optional[int] = None      # None: all of them
    bos_token_id: int = 100000
    eos_token_id: int = 100001
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_config(cls, cfg: dict, **overrides) -> "DeepseekV2Config":
        """From the keys of a published ``config.json`` (unknown keys are
        ignored; a setting this model does not implement raises)."""
        for key, want in _FIXED.items():
            if key in cfg and cfg[key] != want:
                raise ValueError(f"{key}={cfg[key]!r}: only {want!r} is "
                                 f"implemented")
        rs = cfg.get("rope_scaling") or {}
        if rs.get("type", "yarn") != "yarn":
            raise ValueError(f"rope_scaling type {rs['type']!r}: only yarn "
                             f"is implemented")
        kw = {f.name: cfg[f.name] for f in dataclasses.fields(cls)
              if f.name in cfg and f.name != "dtype"}
        for key, name in (("factor", "rope_factor"),
                          ("original_max_position_embeddings",
                           "rope_original_max_position"),
                          ("beta_fast", "rope_beta_fast"),
                          ("beta_slow", "rope_beta_slow"),
                          ("mscale", "rope_mscale"),
                          ("mscale_all_dim", "rope_mscale_all_dim")):
            if key in rs:
                kw[name] = rs[key]
        kw.update(overrides)
        return cls(**kw)

    # What ``models/decoder.Generator`` reads of a configuration.
    @property
    def max_seq_len(self) -> int:
        return self.max_position_embeddings

    @property
    def eos_id(self) -> int:
        return self.eos_token_id

    @property
    def pad_id(self) -> int:
        """Finished rows emit EOS (the published generation config pads
        with it); pad slots of a prompt are never read."""
        return self.eos_token_id

    byte_level = False

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def held(self) -> int:
        """Routed experts this model holds a MoE layer."""
        return (self.n_routed_experts if self.experts_held is None
                else self.experts_held)

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts > 0
                and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)

    @property
    def moe_layers(self) -> list[int]:
        return [i for i in range(self.num_hidden_layers) if self.is_moe(i)]

    def serving_model(self, params, seed: int, device) -> "DeepseekV2LM":
        """The serving module on ``device``. ``params`` (a full state dict)
        whose tensors already lie on ``device`` in the module's dtypes
        become the module's own, with no second copy; other ``params`` are
        copied in; without ``params`` the weights are torch's default
        initialisation from ``seed``."""
        return serve(lambda: DeepseekV2LM(self), params, seed, device)


def serve(make, params, seed: int, device) -> nn.Module:
    """``make()`` on ``device`` for serving: ``params`` (a full state dict)
    whose tensors already lie on ``device`` in the module's dtypes become
    the module's own, with no second copy; other ``params`` are copied in;
    without ``params`` the weights are ``make``'s initialisation from
    ``seed``."""
    from optimized_rag_tpu_torch.models.encoder import serving_module
    device = torch.empty(0, device=device).device   # "cuda" -> "cuda:0"
    if params is not None:
        with torch.device("meta"):
            module = make()
        if all(k in params and params[k].device == device
               and params[k].dtype == v.dtype
               and params[k].shape == v.shape
               for k, v in module.state_dict().items()):
            module.load_state_dict(params, assign=True)
            return module.eval()
    return serving_module(make, params, seed, device)


# ---------------------------------------------------------------------------
# YaRN rotary embedding
# ---------------------------------------------------------------------------

def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(cfg: DeepseekV2Config) -> tuple[int, int]:
    """The dimensions between which YaRN ramps from extrapolated to
    interpolated frequencies."""
    d, base = cfg.qk_rope_head_dim, cfg.rope_theta
    orig = cfg.rope_original_max_position

    def dim(rotations):
        return (d * math.log(orig / (rotations * 2 * math.pi))
                / (2 * math.log(base)))
    low = math.floor(dim(cfg.rope_beta_fast))
    high = math.ceil(dim(cfg.rope_beta_slow))
    return max(low, 0), min(high, d - 1)


def yarn_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """[d_r / 2] float32 inverse frequencies."""
    d, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, d, 2, dtype=torch.float32) / d
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (cfg.rope_factor * base ** exps)
    low, high = yarn_correction_range(cfg)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(d // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(cfg: DeepseekV2Config) -> float:
    m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return cfg.q_head_dim ** -0.5 * m * m


@functools.lru_cache(maxsize=8)
def _inv_freq_on(cfg: DeepseekV2Config, device) -> torch.Tensor:
    return yarn_inv_freq(cfg).to(device)


def rope_cos_sin(cfg: DeepseekV2Config, positions: torch.Tensor):
    """float32 cos and sin [..., d_r] at integer ``positions`` (the
    frequencies are copied to the device once: a copy from pageable memory
    would wait for the device at every step)."""
    inv = _inv_freq_on(cfg, positions.device)
    scale = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
             / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * scale, emb.sin() * scale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """DeepSeek's RoPE of ``x`` [..., d] (interleaved pairs permuted into
    halves first), in float32, rounded once to x's dtype."""
    d = x.shape[-1]
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos + torch.cat([-x2, x1], dim=-1) * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x, out_dtype=None):
        """float32 normalisation times the weight, rounded once to
        ``out_dtype`` (x's dtype by default)."""
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return (h * self.weight.float()).to(out_dtype or x.dtype)


def _linear(i: int, o: int, dtype) -> nn.Linear:
    return nn.Linear(i, o, bias=False, dtype=dtype)


class MLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, hidden: int, width: int, dtype):
        super().__init__()
        self.gate_proj = _linear(hidden, width, dtype)
        self.up_proj = _linear(hidden, width, dtype)
        self.down_proj = _linear(width, hidden, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def expert_counts(flat: torch.Tensor, experts: int) -> torch.Tensor:
    """Tokens routed to each expert (``bincount`` would wait for the device
    to size its output)."""
    return torch.zeros(experts, dtype=torch.long, device=flat.device
                       ).scatter_add_(0, flat, torch.ones_like(flat))


def held_hits(idx, held: int) -> torch.Tensor:
    """The distinct held experts that held ids ``idx`` pick (an absent
    expert's pick is ``held``, ``Experts.local``)."""
    return (expert_counts(idx.reshape(-1), held + 1)[:held] > 0).sum()


class Experts(nn.Module):
    """The routed experts held, stacked: ``gate_up_proj`` [E, 2 I, H] and
    ``down_proj`` [E, H, I]: router ids ``first`` to ``first + E - 1`` of
    ``total`` (all of them by default)."""

    def __init__(self, n: int, hidden: int, width: int, dtype,
                 first: int = 0, total: Optional[int] = None):
        super().__init__()
        self.width = width
        self.first = first
        self.share = total is not None and total > n
        self.gate_up_proj = nn.Parameter(torch.empty(n, 2 * width, hidden,
                                                     dtype=dtype))
        self.down_proj = nn.Parameter(torch.empty(n, hidden, width,
                                                  dtype=dtype))
        # nn.Linear's default, 1 / sqrt(fan_in) bounds, expert by expert
        nn.init.uniform_(self.gate_up_proj, -hidden ** -0.5, hidden ** -0.5)
        nn.init.uniform_(self.down_proj, -width ** -0.5, width ** -0.5)

    def _act(self, gu):
        return F.silu(gu[..., :self.width]) * gu[..., self.width:]

    def local(self, idx):
        """Router ids as held ids from 0; a pick of an absent expert is E
        (the count held). Without a share, ``idx`` itself."""
        if not self.share:
            return idx
        n = self.gate_up_proj.shape[0]
        loc = idx - self.first
        return torch.where((loc >= 0) & (loc < n), loc, n)

    @staticmethod
    def _spans(sizes) -> list:
        """(expert, first row, end row) of each expert with tokens, over
        rows sorted by expert."""
        spans, start = [], 0
        for e, n in enumerate(sizes):
            if n:
                spans.append((e, start, start + n))
            start += n
        return spans

    def grouped(self, x, idx, w):
        """Each held expert's GEMMs over the tokens routed to it: ``x`` [T,
        H], router ids ``idx`` and weights ``w`` [T, k] -> float32 [T, H]
        (the sum over k of the weighted outputs, in the order of k; a pick
        of an absent expert adds 0)."""
        t, k = idx.shape
        n = self.gate_up_proj.shape[0]
        flat = self.local(idx).reshape(-1)
        order = torch.argsort(flat, stable=True)
        sizes = expert_counts(flat, n + self.share).tolist()[:n]  # one wait
        order = order[:sum(sizes)]
        ys = self._gemms(x, order // k, self._spans(sizes))
        out = (ys.new_zeros if self.share else ys.new_empty)(t * k,
                                                             ys.shape[1])
        out[order] = ys
        del ys
        # bf16 times float32 multiplies in float32: one pass, no copy.
        return out.view(t, k, -1).mul(w[..., None]).sum(dim=1)

    def _gemms(self, x, rows, spans):
        """The SwiGLU of rows ``x[rows]``, sorted by expert, each ``spans``
        range through its expert's weights."""
        xs = x[rows]
        gu = xs.new_empty(xs.shape[0], 2 * self.width)
        for e, a, b in spans:
            torch.mm(xs[a:b], self.gate_up_proj[e].t(), out=gu[a:b])
        act = self._act(gu)
        del gu
        ys = torch.empty_like(xs)
        del xs
        for e, a, b in spans:
            torch.mm(act[a:b], self.down_proj[e].t(), out=ys[a:b])
        return ys

    def every(self, x, idx, w):
        """Every expert over every token (three batched GEMMs), the combine
        weights zero off each token's top k (and off absent experts)
        -> float32 [T, H]."""
        n = self.gate_up_proj.shape[0]
        dense = torch.zeros(x.shape[0], n + self.share, dtype=torch.float32,
                            device=x.device)
        dense.scatter_(1, self.local(idx), w)
        dense = dense[:, :n]
        gu = torch.matmul(x, self.gate_up_proj.transpose(1, 2))
        y = torch.matmul(self._act(gu), self.down_proj.transpose(1, 2))
        return torch.einsum("te,eth->th", dense, y.float())


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, dtype):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.gate = _linear(h, cfg.n_routed_experts, dtype)
        if cfg.scoring_func == "sigmoid":
            self.gate.e_score_correction_bias = nn.Parameter(torch.zeros(
                cfg.n_routed_experts, dtype=torch.float32))
        self.experts = Experts(cfg.held, h, cfg.moe_intermediate_size, dtype,
                               cfg.expert_first, cfg.n_routed_experts)
        self.shared_experts = MLP(
            h, cfg.moe_intermediate_size * cfg.n_shared_experts, dtype)

    def route(self, x):
        """float32 router: (expert ids [T, k], weights [T, k])."""
        c = self.cfg
        logits = F.linear(x.float(), self.gate.weight.float())
        if c.scoring_func == "sigmoid":
            scores = torch.sigmoid(logits)
            idx = torch.topk(scores + self.gate.e_score_correction_bias,
                             c.num_experts_per_tok, dim=-1).indices
            w = scores.gather(1, idx)
            if c.norm_topk_prob:
                w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
            return idx, w * c.routed_scaling_factor
        w, idx = torch.topk(torch.softmax(logits, dim=-1),
                            c.num_experts_per_tok, dim=-1)
        if c.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        else:
            w = w * c.routed_scaling_factor
        return idx, w

    def forward(self, x, note=None):
        """x [T, H]; ``note(idx)`` sees each forward's routing."""
        idx, w = self.route(x)
        if note is not None:
            note(idx)
        routed = (self.experts.grouped if x.shape[0] > ALL_EXPERTS_MAX_TOKENS
                  else self.experts.every)(x, idx, w)
        return routed.to(x.dtype) + self.shared_experts(x)


class MLA(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, dtype):
        super().__init__()
        c, h, n = cfg, cfg.hidden_size, cfg.num_attention_heads
        self.cfg = cfg
        self.scale = softmax_scale(cfg)
        self.q_proj = _linear(h, n * c.q_head_dim, dtype)
        self.kv_a_proj_with_mqa = _linear(h, c.latent_dim, dtype)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps, dtype)
        self.kv_b_proj = _linear(c.kv_lora_rank,
                                 n * (c.qk_nope_head_dim + c.v_head_dim),
                                 dtype)
        self.o_proj = _linear(n * c.v_head_dim, h, dtype)

    def _project(self, h, cos, sin):
        """(q_nope [T, n, d_n], q_pe [T, n, d_r] turned, latent [T, r +
        d_r]: the normed c and the turned k_pe) of h [T, H]."""
        c = self.cfg
        q = self.q_proj(h).unflatten(-1, (c.num_attention_heads,
                                          c.q_head_dim))
        q_nope, q_pe = q.split([c.qk_nope_head_dim, c.qk_rope_head_dim], -1)
        lat, k_pe = self.kv_a_proj_with_mqa(h).split(
            [c.kv_lora_rank, c.qk_rope_head_dim], -1)
        if not c.mla_use_nope:
            q_pe = apply_rope(q_pe, cos.unsqueeze(-2), sin.unsqueeze(-2))
            k_pe = apply_rope(k_pe, cos, sin)
        lat = torch.cat([self.kv_a_layernorm(lat), k_pe], dim=-1)
        return q_nope, q_pe, lat

    def prefill(self, h, cache, segments, cos, sin):
        """One prefill chunk: h [T, H], the tokens of ``segments`` packed
        in order, each ``(row, first, a, e)``: row ``row``'s cache slots
        [a, e), whose real positions start at slot ``first``. Writes each
        segment's latent into ``cache`` [B, S, r + d_r], then attends
        causally over the row's cached positions, expanded."""
        c = self.cfg
        n = c.num_attention_heads
        q_nope, q_pe, lat = self._project(h, cos, sin)
        q = torch.cat([q_nope, q_pe], dim=-1)
        outs, off = [], 0
        for row, first, a, e in segments:
            t = e - a
            cache[row, a:e] = lat[off:off + t]
            cached = cache[row, first:e]
            kv = F.linear(cached[:, :c.kv_lora_rank], self.kv_b_proj.weight
                          ).unflatten(-1, (n, -1))
            k_nope, v = kv.split([c.qk_nope_head_dim, c.v_head_dim], -1)
            k = torch.cat([k_nope, cached[:, None, c.kv_lora_rank:].expand(
                -1, n, -1)], dim=-1)
            outs.append(causal_attention(q[off:off + t], k, v, self.scale))
            off += t
        o = outs[0] if len(outs) == 1 else torch.cat(outs)
        return self.o_proj(o.flatten(-2))

    def decode(self, h, cache, slot, lo: int, valid, cos, sin):
        """One step of every row: h [B, H] written at cache slot ``slot``
        (a one-element tensor) of ``cache`` [B, S, r + d_r]; attends,
        absorbed, over slots [lo, S) where ``valid`` [B, S - lo] holds."""
        c = self.cfg
        n, r = c.num_attention_heads, c.kv_lora_rank
        q_nope, q_pe, lat = self._project(h, cos, sin)
        cache.index_copy_(1, slot, lat[:, None])
        w = self.kv_b_proj.weight.unflatten(0, (n, -1))   # [n, d_n+d_v, r]
        w_uk, w_uv = w.split([c.qk_nope_head_dim, c.v_head_dim], dim=1)
        q_lat = torch.einsum("bhd,hdr->bhr", q_nope, w_uk)
        keys = cache[:, lo:]
        att = torch.bmm(torch.cat([q_lat, q_pe], dim=-1),
                        keys.transpose(1, 2)).float() * self.scale
        att = torch.softmax(torch.where(valid[:, None, :], att, MASKED),
                            dim=-1)
        o_lat = torch.bmm(att.to(h.dtype), keys[..., :r])
        o = torch.einsum("bhr,hdr->bhd", o_lat, w_uv)
        return self.o_proj(o.flatten(-2))


def causal_attention(q, k, v, scale: float):
    """q [T, n, d], k [L, n, d], v [L, n, d_v], the T queries the last of
    the L positions -> [T, n, d_v], through
    ``scaled_dot_product_attention`` (on the card a fused kernel only)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right
    t, length = q.shape[0], k.shape[0]
    qt, kt, vt = (x.transpose(0, 1)[None] for x in (q, k, v))
    kw = ({"is_causal": True} if t == length
          else {"attn_mask": causal_lower_right(t, length)})
    if q.device.type == "cuda":
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION,
                          SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            o = F.scaled_dot_product_attention(qt, kt, vt, scale=scale, **kw)
    else:
        o = F.scaled_dot_product_attention(qt, kt, vt, scale=scale, **kw)
    return o[0].transpose(0, 1)


class Layer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, index: int, dtype):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(h, eps, dtype)
        self.self_attn = MLA(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(h, eps, dtype)
        self.mlp = (MoE(cfg, dtype) if cfg.is_moe(index)
                    else MLP(h, cfg.intermediate_size, dtype))

    def ffn(self, x, note=None):
        h = self.post_attention_layernorm(x)
        if isinstance(self.mlp, MoE):
            return x + self.mlp(h, note=note)
        return x + self.mlp(h)


class DeepseekV2LM(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, param_dtype=None):
        super().__init__()
        dt = param_dtype or cfg.dtype
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=dt)
        self.layers = nn.ModuleList(Layer(cfg, i, dt)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dt)
        self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size, dt)
        self._moe_index = {i: j for j, i in enumerate(cfg.moe_layers)}

    @property
    def dtype(self):
        return self.embed_tokens.weight.dtype

    def head(self, x):
        """float32 final norm and head -> float32 logits."""
        h = self.norm(x, torch.float32)
        return F.linear(h, self.lm_head.weight.float())

    def _note(self, probe, layer: int):
        if probe is None or layer not in self._moe_index:
            return None
        j, n = self._moe_index[layer], len(self._moe_index)
        e, local = self.cfg.held, self.layers[layer].mlp.experts.local
        return lambda idx: probe.route(j, n, e, local(idx))

    def new_cache(self, batch: int, slots: int, device) -> torch.Tensor:
        """The latent cache, zeroed: [layers, B, S, r + d_r] (a masked slot
        is still read, and 0 times a stale NaN would not vanish)."""
        c = self.cfg
        return torch.zeros(c.num_hidden_layers, batch, slots, c.latent_dim,
                           dtype=self.dtype, device=device)

    def _chunk(self, ids, cache, segments, probe=None):
        """The final hidden states [T, H] of one prefill chunk (``MLA.
        prefill``'s ``segments``, ids [B, P] by slot), written through
        every layer's cache ``cache`` [layers, B, S, r + d_r]."""
        dev = ids.device
        x = F.embedding(torch.cat([ids[r, a:e] for r, _, a, e in segments]),
                        self.embed_tokens.weight)
        cos, sin = rope_cos_sin(self.cfg, torch.cat([
            torch.arange(a - f, e - f, device=dev)
            for _, f, a, e in segments]))
        for i, layer in enumerate(self.layers):
            x = x + layer.self_attn.prefill(layer.input_layernorm(x),
                                            cache[i], segments, cos, sin)
            x = layer.ffn(x, self._note(probe, i))
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
            for segs in prefill_chunks([0], length, chunk or length)]))

    def prefill(self, ids, pad_len, pad_mask, pos_ids, total: int,
                chunk: Optional[int] = None, probe=None):
        """LEFT-padded ids [B, P] with pad counts [B] -> (float32 logits
        [B, V] at each row's last position, the latent cache of ``total``
        slots). The rows' real positions run packed, in chunks of at most
        ``chunk`` tokens (default P; ``prefill_chunks``); pad slots are
        never computed. ``pad_mask`` and ``pos_ids`` are not
        needed."""
        b, p = ids.shape
        pads = [int(x) for x in pad_len.tolist()]
        cache = self.new_cache(b, total, ids.device)
        last = [None] * b
        for segs in prefill_chunks(pads, p, chunk or p):
            x = self._chunk(ids, cache, segs, probe)
            off = 0
            for r, _, a, e in segs:
                off += e - a
                if e == p:
                    last[r] = x[off - 1]
        return (self.head(torch.stack(last)),
                _Cache(cache, min(pads) // 8 * 8))

    def decode(self, toks, slot: int, cache: "_Cache", storage_valid,
               pos_ids, probe=None):
        """One step: tokens [B] at storage slot ``slot``, RoPE positions
        ``pos_ids`` [B] -> float32 logits [B, V] (``_DecodeStep``'s buffer:
        read it before the next step)."""
        if cache.step is None:
            cache.step = _DecodeStep(self, cache, storage_valid,
                                     probe is not None)
        out = cache.step(toks, slot, pos_ids)
        if probe is not None:
            probe.step_hits(cache.step.hit)
        return out


class _DecodeStep:
    """A decode step of every row on buffers that keep their addresses, so
    that on the card it is captured as a CUDA graph at the call's first
    step and replayed at every later one (eager, a step issued some 2,700
    launches and the host paced the card). Its shapes do not change within
    a call: attention reads the cache from ``lo`` (a multiple of 8 at or
    below every row's first real slot) to its end, the slots past the
    step's masked (a row stride off 8 sends the attention's GEMMs to
    kernels for unaligned operands). ``hit``: distinct experts the step's
    tokens hit, a MoE layer (where counted)."""

    def __init__(self, model: DeepseekV2LM, cache: "_Cache", storage_valid,
                 count: bool):
        dev = storage_valid.device
        b, slots = storage_valid.shape
        self.model, self.buf, self.lo = model, cache.buf, cache.lo
        self.toks = torch.zeros(b, dtype=torch.long, device=dev)
        self.pos = torch.zeros(b, dtype=torch.long, device=dev)
        self.slot = torch.zeros(1, dtype=torch.long, device=dev)
        self.storage_valid = storage_valid[:, self.lo:]
        self.cols = torch.arange(self.lo, slots, device=dev)
        self.hit = (torch.zeros(len(model._moe_index), dtype=torch.long,
                                device=dev) if count else None)
        self.graph = self.out = None
        self.cuda = dev.type == "cuda"

    def _note(self, layer: int):
        if self.hit is None or layer not in self.model._moe_index:
            return None
        j, e = self.model._moe_index[layer], self.model.cfg.held
        local = self.model.layers[layer].mlp.experts.local
        return lambda idx: self.hit[j].copy_(held_hits(local(idx), e))

    def _run(self):
        m = self.model
        x = F.embedding(self.toks, m.embed_tokens.weight)
        cos, sin = rope_cos_sin(m.cfg, self.pos)
        valid = self.storage_valid & (self.cols <= self.slot)
        for i, layer in enumerate(m.layers):
            x = x + layer.self_attn.decode(layer.input_layernorm(x),
                                           self.buf[i], self.slot, self.lo,
                                           valid, cos, sin)
            x = layer.ffn(x, self._note(i))
        return m.head(x)

    def __call__(self, toks, slot: int, pos_ids):
        self.toks.copy_(toks)
        self.pos.copy_(pos_ids)
        self.slot.fill_(slot)
        if self.graph is not None:
            self.graph.replay()
            return self.out
        out = self._run()
        if self.cuda:
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._run()
        return out


def prefill_chunks(pads, p: int, chunk: int) -> list:
    """The rows' real slots [pad, p) in chunks of at most ``chunk`` tokens:
    a list of chunks, each a list of segments ``(row, first real slot, a,
    e)``. Rows go longest first, each whole into the current chunk while
    it fits, else into a new one; only a row longer than ``chunk`` is cut.
    A whole row attends over itself in one causal kernel, and the chunks
    depend on the rows' lengths, not on their order in the batch."""
    chunks, cur, room = [], [], chunk
    for r in sorted(range(len(pads)), key=lambda r: (pads[r], r)):
        first = pads[r]
        if cur and p - first > room:
            chunks.append(cur)
            cur, room = [], chunk
        a = first
        while a < p:
            e = min(p, a + room)
            cur.append((r, first, a, e))
            room -= e - a
            a = e
            if room == 0:
                chunks.append(cur)
                cur, room = [], chunk
    if cur:
        chunks.append(cur)
    return chunks


@dataclasses.dataclass
class _Cache:
    buf: torch.Tensor       # [layers, B, S, r + d_r]
    lo: int                 # the first slot decode reads: a multiple of 8
                            # at or below any row's first real slot
    step: Optional[_DecodeStep] = None

    def byte_sizes(self) -> dict:
        return {"latent_bytes": self.buf.nbytes}
