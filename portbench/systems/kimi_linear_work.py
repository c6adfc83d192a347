"""Operations and bytes of the Kimi Linear kind (``systems/kimi_linear.py``):
the model's FLOPs over real tokens, a decode step's least bytes, and the
least work of the KDA prefill's walk over chunks, at the peaks of
``work.py``.

Counts are of what the inputs need, for this rank's share. A token's
linear FLOPs are 2 per weight of every matmul it passes: in a KDA layer q,
k, v, the gate's and the decay's low-rank pairs, beta and o, and the
convolutions' taps; in an MLA layer q, kv_a, kv_b and o; the dense SwiGLU
or, in a MoE layer, the router, the shared expert, and the routed experts
this share holds at the expected picks a token (k x held / router width:
8 x 64 / 256 = 2). MLA attention is counted in the expanded form, per
(query, key) pair 2 n (d_n + d_r) for the score and 2 n d_v for the
weighted sum, causally over real positions. KDA is counted in its chunked
form, per head and chunk of c real tokens: the two pair blocks (c(c-1)/2
and c(c+1)/2 pairs of 2 d_k), the triangular solve (c(c-1)/2 of 2 (d_k +
d_v)), and the walk (``kda_walk_flops``). The head runs at each prompt's
last position and at every decode token.

A decode step reads every weight but the routed experts and the embedding
once, the held experts its tokens hit (the program's counter), one
embedding row a token, the latent cache of the MLA layers at every real
position its tokens attend to, and the KDA state once and writes it once.

The walk (``kda_walk_*``): per head and chunk of c tokens, 3 products of
2 c d_k d_v (u' = U - W S, Q~ S, K^T u') and A_qk u' (c(c+1)/2 pairs of
2 d_v); it reads W, U, Q~ and K^ (c rows of 128 each) and A_qk's lower
triangle in the model's dtype (the least any implementation of the same
pass reads), exp(G_C) in float32, the initial state and writes the final
one in float32 once a row, and writes o in the model's dtype. Rows are
counted whole.
"""

from __future__ import annotations

from portbench.reference.kimi_linear import kda_layers, param_shapes, share
from portbench.work import BYTES, PEAK, PEAK_BW, bound_ms  # noqa: F401

CHUNK = 64


def _n(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out


def counts(cfg: dict) -> tuple[int, int, int, int]:
    """(KDA layers, MLA layers, dense FFN layers, MoE layers)."""
    layers = cfg["num_hidden_layers"]
    lin = len(kda_layers(cfg))
    dense = min(cfg["first_k_dense_replace"], layers)
    return lin, layers - lin, dense, layers - dense


def kda_dims(cfg: dict) -> tuple[int, int, int]:
    lac = cfg["linear_attn_config"]
    return lac["num_heads"], lac["head_dim"], lac["short_conv_kernel_size"]


def expert_params(cfg: dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def total_params(cfg: dict) -> int:
    return sum(_n(s) for s in param_shapes(cfg).values())


def expected_picks(cfg: dict) -> float:
    """Picks of held experts a token and MoE layer, expected."""
    _, held, total = share(cfg)
    return cfg["num_experts_per_token"] * held / total


def token_linear_params(cfg: dict) -> float:
    """Weights of the matmuls one token passes (the convolutions' taps
    counted as weights), the head left out."""
    h, n = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    kn, kd, taps = kda_dims(cfg)
    width = kn * kd
    mla = h * n * (dn + dr) + h * (r + dr) + r * n * (dn + dv) + n * dv * h
    kda = (3 * width * (h + taps) + 2 * (h * kd + kd * width) + h * kn
           + width * h)
    lin, full, dense, moe = counts(cfg)
    _, _, total = share(cfg)
    per_moe = (total * h + expected_picks(cfg) * expert_params(cfg)
               + cfg["num_shared_experts"] * expert_params(cfg))
    return (lin * kda + full * mla + dense * 3 * h * cfg["intermediate_size"]
            + moe * per_moe)


def pair_flops(cfg: dict) -> int:
    """One MLA layer's attention FLOPs for one (query, key) pair."""
    n = cfg["num_attention_heads"]
    return 2 * n * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                    + cfg["v_head_dim"])


def head_flops(cfg: dict) -> int:
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def _chunks(length: int):
    full, rest = divmod(length, CHUNK)
    return [CHUNK] * full + ([rest] if rest else [])


def kda_walk_flops(cfg: dict, length: int) -> float:
    """The walk over one row of ``length`` tokens, every head, one
    layer."""
    kn, kd, _ = kda_dims(cfg)
    return float(kn * sum(6 * c * kd * kd + c * (c + 1) * kd
                          for c in _chunks(length)))


def kda_walk_bytes(cfg: dict, length: int) -> float:
    kn, kd, _ = kda_dims(cfg)
    w = BYTES["bfloat16"]
    per = sum(w * (5 * c * kd + c * (c + 1) // 2) + 4 * kd
              for c in _chunks(length))
    return float(kn * (per + 2 * 4 * kd * kd))


def kda_walk_bound_ms(cfg: dict, lengths) -> float:
    """The least time of one layer's walk over rows of ``lengths``."""
    return bound_ms(sum(kda_walk_bytes(cfg, n) for n in lengths),
                    sum(kda_walk_flops(cfg, n) for n in lengths),
                    PEAK["bfloat16"])[0]


def kda_chunked_flops(cfg: dict, length: int) -> float:
    """KDA's chunked form over one row, every head, one layer: the pair
    blocks, the solve and the walk."""
    kn, kd, _ = kda_dims(cfg)
    inner = sum(c * (c - 1) * kd + c * (c + 1) * kd + c * (c - 1) * 2 * kd
                for c in _chunks(length))
    return float(kn * inner) + kda_walk_flops(cfg, length)


def prefill_flops(cfg: dict, lengths) -> float:
    """Prompts of ``lengths`` real tokens, the head at each last one."""
    lin, full, _, _ = counts(cfg)
    lp = token_linear_params(cfg)
    return float(sum(2 * lp * n + full * pair_flops(cfg) * n * (n + 1) // 2
                     + lin * kda_chunked_flops(cfg, n) + head_flops(cfg)
                     for n in lengths))


def kda_step_flops(cfg: dict) -> int:
    """One token's recurrent step, every head, one layer: S^T k, the
    rank-one update and S^T q."""
    kn, kd, _ = kda_dims(cfg)
    return 6 * kn * kd * kd


def decode_step_flops(cfg: dict, batch: int, positions: int) -> float:
    """``batch`` tokens attending to ``positions`` real positions in all
    (in each MLA layer)."""
    lin, full, _, _ = counts(cfg)
    return float(batch * (2 * token_linear_params(cfg) + head_flops(cfg)
                          + lin * kda_step_flops(cfg))
                 + full * pair_flops(cfg) * positions)


def state_bytes(cfg: dict, batch: int) -> int:
    """The KDA state of ``batch`` rows, every KDA layer, float32."""
    lin, _, _, _ = counts(cfg)
    kn, kd, _ = kda_dims(cfg)
    return lin * batch * kn * kd * kd * 4


def decode_step_bytes(cfg: dict, hit, batch: int, positions: int) -> float:
    """``hit``: the distinct held experts the step's tokens hit, a MoE
    layer."""
    _, full, _, moe = counts(cfg)
    _, held, _ = share(cfg)
    w = BYTES["bfloat16"]
    h = cfg["hidden_size"]
    fixed = (total_params(cfg) - moe * held * expert_params(cfg)
             - cfg["vocab_size"] * h)
    latent = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    return float(w * (fixed + sum(hit) * expert_params(cfg) + batch * h
                      + full * latent * positions)
                 + 2 * state_bytes(cfg, batch))


def decode_step_bound_ms(cfg: dict, hit, batch: int, positions: int):
    return bound_ms(decode_step_bytes(cfg, hit, batch, positions),
                    decode_step_flops(cfg, batch, positions),
                    PEAK["bfloat16"])[0]
