"""Operations and bytes of the generator kind (``systems/generator.py``):
the model's FLOPs over real tokens and a decode step's least bytes, at the
peaks of ``work.py``.

Counts are of what the inputs need. A token's linear FLOPs are 2 per
weight of every matmul it passes: q, kv_a, kv_b and o in every layer, the
dense SwiGLU or, in a MoE layer, the router, its top-k experts and the
shared experts. Attention is counted in the expanded form, per layer and
per (query, key) pair 2 n (d_n + d_r) for the score and 2 n d_v for the
weighted sum, causally over real positions. The head runs at each prompt's
last position and at every decode token. A decode step reads every weight
but the routed experts and the embedding table once, the experts that its
tokens hit (the program's routing counter), one embedding row a token, and
the latent cache (r + d_r values a layer) at every real position its
tokens attend to.
"""

from __future__ import annotations

from portbench.work import BYTES, PEAK, PEAK_BW, bound_ms  # noqa: F401
from portbench.reference.deepseek_v2 import is_moe, param_shapes


def _n(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out


def layer_counts(cfg: dict) -> tuple[int, int]:
    """(dense layers, MoE layers)."""
    moe = sum(is_moe(cfg, i) for i in range(cfg["num_hidden_layers"]))
    return cfg["num_hidden_layers"] - moe, moe


def expert_params(cfg: dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def total_params(cfg: dict) -> int:
    return sum(_n(s) for s in param_shapes(cfg).values())


def token_linear_params(cfg: dict) -> int:
    """Weights of the matmuls one token passes, the head left out."""
    h, n = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    attn = h * n * (dn + dr) + h * (r + dr) + r * n * (dn + dv) + n * dv * h
    dense, moe = layer_counts(cfg)
    shared = expert_params(cfg) * cfg["n_shared_experts"]
    per_moe = (cfg["n_routed_experts"] * h + cfg["num_experts_per_tok"]
               * expert_params(cfg) + shared)
    return (cfg["num_hidden_layers"] * attn
            + dense * 3 * h * cfg["intermediate_size"] + moe * per_moe)


def pair_flops(cfg: dict) -> int:
    """One layer's attention FLOPs for one (query, key) pair."""
    n = cfg["num_attention_heads"]
    return 2 * n * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                    + cfg["v_head_dim"])


def head_flops(cfg: dict) -> int:
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def prefill_flops(cfg: dict, lengths) -> float:
    """Prompts of ``lengths`` real tokens, the head at each last one."""
    lin, layers = token_linear_params(cfg), cfg["num_hidden_layers"]
    return float(sum(2 * lin * n + layers * pair_flops(cfg) * n * (n + 1)
                     // 2 + head_flops(cfg) for n in lengths))


def decode_step_flops(cfg: dict, batch: int, positions: int) -> float:
    """``batch`` tokens attending to ``positions`` real positions in all."""
    return float(batch * (2 * token_linear_params(cfg) + head_flops(cfg))
                 + cfg["num_hidden_layers"] * pair_flops(cfg) * positions)


def decode_step_bytes(cfg: dict, hit, batch: int, positions: int) -> float:
    """``hit``: the distinct experts the step's tokens hit, a MoE layer."""
    _, moe = layer_counts(cfg)
    w = BYTES["bfloat16"]
    h = cfg["hidden_size"]
    fixed = (total_params(cfg) - moe * cfg["n_routed_experts"]
             * expert_params(cfg) - cfg["vocab_size"] * h)
    latent = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    return float(w * (fixed + sum(hit) * expert_params(cfg) + batch * h
                      + cfg["num_hidden_layers"] * latent * positions))


def decode_step_bound_ms(cfg: dict, hit, batch: int, positions: int):
    return bound_ms(decode_step_bytes(cfg, hit, batch, positions),
                    decode_step_flops(cfg, batch, positions),
                    PEAK["bfloat16"])[0]
