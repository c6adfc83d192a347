"""DeepSeek-V2 in the port (``models/deepseek_v2.py``) through ``Generator``,
held against the plain float32 reference ``tests/deepseek_v2_reference.py``
at a small size with seeded random weights (hidden 64, 4 heads, qk_nope 16,
qk_rope 8, v 16, kv_lora 32, 3 layers of which 1 dense, 8 experts top-2
plus 2 shared, vocabulary 512); the published configuration only on the
meta device."""

import json
import math
import os
import time

import numpy as np
import pytest
import torch

import deepseek_v2_reference as ref
from optimized_rag_tpu_torch.models import decoder as pd
from optimized_rag_tpu_torch.models import deepseek_v2 as ds
from optimized_rag_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "portbench", "configs",
                       "deepseek-v2-lite.bf16.json"), encoding="utf-8") as f:
    PUBLISHED = json.load(f)
SMALL = dict(PUBLISHED, hidden_size=64, intermediate_size=96,
             moe_intermediate_size=24, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=4,
             n_routed_experts=8, n_shared_experts=2, num_experts_per_tok=2,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, vocab_size=512, bos_token_id=500,
             eos_token_id=501)
CPU = torch.device("cpu")


def small_cfg(dtype=torch.float32) -> ds.DeepseekV2Config:
    return ds.DeepseekV2Config.from_config(SMALL, dtype=dtype)


def weights(seed: int) -> dict:
    """float32 state dict of the small model, drawn from ``seed``:
    matrices N(0, 0.1), the embedding N(0, 1), norm weights around 1 (so
    a norm's weight is not the identity)."""
    with torch.device("meta"):
        shapes = ds.DeepseekV2LM(small_cfg()).state_dict()
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in shapes.items():
        x = torch.randn(t.shape, generator=g)
        if "norm" in name:
            x = 1.0 + 0.1 * x
        elif not name.startswith("embed"):
            x = 0.1 * x
        out[name] = x
    return out


def model(seed: int, dtype=torch.float32):
    params = {k: v.to(dtype) for k, v in weights(seed).items()}
    return small_cfg(dtype).serving_model(params, 0, CPU), params


def prompt(seed: int, length: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 500, (length,), generator=g)
    ids[0] = SMALL["bos_token_id"]
    return ids


def rel_err(a, b) -> torch.Tensor:
    """Relative L2 error of each row of ``a`` against ``b``."""
    return (a.double() - b.double()).norm(dim=-1) / b.double().norm(dim=-1)


@pytest.mark.parametrize("chunk", [None, 5])
def test_full_forward_float32_matches_reference(chunk):
    m, params = model(1)
    ids = prompt(2, 23)
    with torch.inference_mode():
        got = m(ids, chunk=chunk)
    want = ref.forward(params, SMALL, ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_bfloat16_forward_within_its_rounding():
    """bf16 rounds each product and activation to 8 bits of mantissa
    (relative 2^-9 = 0.2%): through 3 layers, 2 norms and a routed sum a
    layer, a row's relative logit error read 0.5-0.8% on 7 of 8 seeds and
    3.1% on one, where a routing flip (a near-tie of the 2nd and 3rd
    expert moved by the rounding) changes a token's expert. 0.06 is about
    twice the largest."""
    errs = []
    for seed in range(8):
        m, params = model(seed, torch.bfloat16)
        ids = prompt(seed + 100, 19)
        with torch.inference_mode():
            got = m(ids)
        want = ref.forward(params, SMALL, ids)
        errs.append(float(rel_err(got, want).max()))
    assert max(errs) < 0.06, errs
    assert min(errs) > 1e-4, errs     # it did run in bfloat16


@pytest.mark.parametrize("threshold", [ds.ALL_EXPERTS_MAX_TOKENS, 0])
@pytest.mark.parametrize("chunk", [None, 4, 20])
def test_generator_matches_reference_at_every_decoded_position(
        monkeypatch, threshold, chunk):
    """Prefill into the latent cache, then cached decode, over a
    LEFT-padded batch of unequal lengths: the logits each step picked from
    equal the reference's full forward over prompt plus emitted tokens.
    ``chunk`` 4 splits each row across chunks, 20 packs two rows into
    one; ``threshold`` 0 sends every forward through the grouped
    experts."""
    monkeypatch.setattr(ds, "ALL_EXPERTS_MAX_TOKENS", threshold)
    cfg = small_cfg()
    params = weights(3)
    gen = pd.Generator(cfg, params=params, max_prompt_len=16,
                       max_new_tokens=6, device="cpu", prefill_chunk=chunk)
    prompts = [prompt(10, 13).tolist(), prompt(11, 7).tolist(),
               prompt(12, 16).tolist()]
    out = gen.generate_ids(prompts, keep_logits=[0, 1, 2])
    assert out.tokens.shape == (6, 3)
    assert out.logits.shape == (6, 3, SMALL["vocab_size"])
    for r, p in enumerate(prompts):
        toks = out.tokens[:, r]
        seq = torch.cat([torch.tensor(p), toks[:-1]])
        want = ref.forward(params, SMALL, seq)[len(p) - 1:]
        torch.testing.assert_close(out.logits[:, r], want, rtol=1e-4,
                                   atol=1e-4)
        assert (toks == out.logits[:, r].argmax(-1)).all()


def test_absorbed_decode_equals_the_expanded_form():
    cfg = small_cfg()
    torch.manual_seed(4)
    mla = ds.MLA(cfg, torch.float32)
    with torch.no_grad():
        for p in mla.parameters():
            p.normal_(0, 0.2)
    length = 11
    h = torch.randn(length, cfg.hidden_size)
    cos, sin = ds.rope_cos_sin(cfg, torch.arange(length))
    with torch.inference_mode():
        full = mla.prefill(h, torch.zeros(1, length, cfg.latent_dim),
                           [(0, 0, 0, length)], cos, sin)
        cache = torch.zeros(1, 16, cfg.latent_dim)
        mla.prefill(h[:-1], cache, [(0, 0, 0, length - 1)], cos[:-1],
                    sin[:-1])
        valid = torch.arange(16)[None] < length
        step = mla.decode(h[-1:], cache, torch.tensor([length - 1]), 0,
                          valid, cos[-1:], sin[-1:])
    torch.testing.assert_close(step[0], full[-1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("threshold", [ds.ALL_EXPERTS_MAX_TOKENS, 0])
def test_moe_layer_matches_the_reference_loop_and_counts_its_routing(
        monkeypatch, threshold):
    """37 tokens run every expert at the default threshold, the grouped
    experts at 0."""
    monkeypatch.setattr(ds, "ALL_EXPERTS_MAX_TOKENS", threshold)
    cfg = small_cfg()
    m, params = model(5)
    moe = m.layers[1].mlp
    x = torch.randn(37, cfg.hidden_size, generator=torch.Generator(
        ).manual_seed(6))
    probe = pd._Probe(CPU, 4)
    with torch.inference_mode():
        got = moe(x, note=lambda idx: probe.route(
            0, 1, cfg.n_routed_experts, idx))
    p = ref.sub(params, "layers.1.mlp.")
    torch.testing.assert_close(got, ref.moe(p, SMALL, x), rtol=1e-5,
                               atol=1e-5)
    idx, _ = ref.route(p, SMALL, x)
    want = torch.bincount(idx.reshape(-1), minlength=cfg.n_routed_experts)
    assert probe.expert_tokens[0].tolist() == want.tolist()


def test_yarn_past_the_original_context():
    """At position 5,000 (past the 4,096 original positions) the published
    YaRN settings give the reference's cos and sin; extrapolated
    frequencies below the correction range [10, 23], interpolated (over
    40) above it; cos and sin scaled by exactly 1; the softmax scale
    192^-0.5 m^2 with m = 0.1 * 0.707 * ln 40 + 1."""
    cfg = ds.DeepseekV2Config.from_config(PUBLISHED)
    assert ds.yarn_correction_range(cfg) == (10, 23)
    inv = ds.yarn_inv_freq(cfg)
    base = 10000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    torch.testing.assert_close(inv[:11], 1.0 / base[:11])
    torch.testing.assert_close(inv[23:], 1.0 / (40 * base[23:]))
    assert ((inv[11:23] < 1.0 / base[11:23])
            & (inv[11:23] > 1.0 / (40 * base[11:23]))).all()
    pos = torch.tensor([4095, 5000, 16511])
    cos, sin = ds.rope_cos_sin(cfg, pos)
    rcos, rsin = ref.cos_sin(PUBLISHED, 16512, CPU)
    torch.testing.assert_close(cos, rcos[pos], rtol=0, atol=1e-6)
    torch.testing.assert_close(sin, rsin[pos], rtol=0, atol=1e-6)
    _, mscale = ref.yarn_inv_freq_and_mscale(PUBLISHED)
    assert mscale == 1.0
    m = 0.1 * 0.707 * math.log(40) + 1
    assert ds.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m,
                                                  rel=1e-12)
    assert ds.softmax_scale(cfg) == pytest.approx(ref.softmax_scale(
        PUBLISHED), rel=1e-12)


def test_published_configuration_has_its_parameter_count():
    cfg = ds.DeepseekV2Config.from_config(PUBLISHED)
    assert (cfg.num_hidden_layers, cfg.n_routed_experts,
            cfg.num_experts_per_tok, cfg.n_shared_experts,
            cfg.kv_lora_rank, cfg.vocab_size) == (27, 64, 6, 2, 512, 102400)
    assert cfg.moe_layers == list(range(1, 27))
    with torch.device("meta"):
        lm = ds.DeepseekV2LM(cfg)
    assert sum(p.numel() for p in lm.parameters()) == 15_706_484_224
    assert lm.new_cache(1, 1, "meta").shape[-1] * 27 * 2 == 31_104


def test_from_config_refuses_what_it_does_not_implement():
    with pytest.raises(ValueError, match="q_lora_rank"):
        ds.DeepseekV2Config.from_config(dict(PUBLISHED, q_lora_rank=1536))
    with pytest.raises(ValueError, match="topk_method"):
        ds.DeepseekV2Config.from_config(dict(PUBLISHED,
                                             topk_method="group_limited"))


def test_params_on_the_device_are_taken_without_a_copy():
    params = {k: v.to(torch.bfloat16) for k, v in weights(7).items()}
    m = small_cfg(torch.bfloat16).serving_model(params, 0, CPU)
    state = m.state_dict()
    assert all(state[k].data_ptr() == v.data_ptr() for k, v in params.items())


def test_text_prompts_name_the_missing_tokenizer():
    gen = pd.Generator(small_cfg(), params=weights(8), max_prompt_len=8,
                       max_new_tokens=2, device="cpu")
    provider = pd.LocalLMProvider(gen)
    with pytest.raises(ValueError, match="tokenizer"):
        provider.complete("What does the index hold?", task="generate")
    with pytest.raises(ValueError, match="tokenizer"):
        gen.score("text")


def test_generation_spans_and_routing_counts():
    """With a profiler session on, a call records ``generate`` (B, padded
    P, real prompt tokens, steps, the latent cache's bytes) with
    ``generate.prefill`` (chunks,
    tokens, real; tokens per expert per MoE layer: each real token k
    times) and ``generate.decode`` (steps; distinct experts hit a layer a
    step); finished rows emit the configuration's EOS as padding."""
    cfg = small_cfg()
    gen = pd.Generator(cfg, params=weights(9), max_prompt_len=12,
                       max_new_tokens=5, device="cpu", prefill_chunk=4)
    prompts = [prompt(20, 9).tolist(), prompt(21, 12).tolist()]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        out = gen.generate_ids(prompts)
    recs = {r.name: r for r in profiling.RECORDER.records(t0)}
    top, pre, dec = (recs[n] for n in ("generate", "generate.prefill",
                                       "generate.decode"))
    assert pre.parent == top.id and dec.parent == top.id
    # the latent cache: 3 layers x 2 rows x (12 + 5) slots x (32 + 8)
    # float32 values
    assert top.attrs == {"B": 2, "P": 12, "prompt_tokens": 21,
                         "new_tokens": 5, "steps": 4,
                         "latent_bytes": 3 * 2 * 17 * 40 * 4}
    assert (pre.attrs["chunks"], pre.attrs["tokens"], pre.attrs["real"]) \
        == (6, 21, 21)
    counts = np.asarray(pre.attrs["expert_tokens"])
    assert counts.shape == (2, 8) and (counts.sum(1) == 21 * 2).all()
    assert pre.attrs["remote_picks"] == 0       # every expert is held
    hit = np.asarray(dec.attrs["experts_hit"])
    assert hit.shape == (4, 2) and ((hit >= 2) & (hit <= 4)).all()
    assert pre.attrs["device_ms"] is None     # no card
    assert out.tokens.shape == (5, 2)
