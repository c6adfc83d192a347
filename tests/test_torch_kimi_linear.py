"""Kimi Linear in the port (``models/kimi_linear.py``) through ``Generator``,
held against the plain float32 reference ``tests/kimi_linear_reference.py``
at a small size with seeded random weights: one period of the layer
pattern (3 KDA layers of 2 heads of 16, then 1 NoPE MLA layer of 4 heads,
qk_nope 16, qk_rope 8, v 16, kv_lora 32), hidden 64, a dense first layer,
a router over 16 experts top-4 of which this share holds 4 (rank 0 of 4),
1 shared expert, vocabulary 512. The published configuration only on the
meta device."""

import hashlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import kimi_linear_reference as ref
from optimized_rag_tpu_torch.models import decoder as pd
from optimized_rag_tpu_torch.models import deepseek_v2 as ds
from optimized_rag_tpu_torch.models import kimi_linear as kl
from optimized_rag_tpu_torch.ops import kda
from optimized_rag_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "portbench", "configs",
                       "kimi-linear-48b-a3b.ep4.bf16.json"),
          encoding="utf-8") as f:
    PUBLISHED = json.load(f)
SMALL = dict(PUBLISHED, hidden_size=64, intermediate_size=96,
             moe_intermediate_size=24, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             vocab_size=512, bos_token_id=500, eos_token_id=501,
             num_experts=4, num_experts_per_token=4,
             expert_parallel={"ranks": 4, "rank": 0},
             linear_attn_config={"full_attn_layers": [4],
                                 "kda_layers": [1, 2, 3], "head_dim": 16,
                                 "num_heads": 2, "short_conv_kernel_size": 4})
CPU = torch.device("cpu")


def small_cfg(dtype=torch.float32, **keys) -> kl.KimiLinearConfig:
    return kl.KimiLinearConfig.from_config(dict(SMALL, **keys), dtype=dtype)


def weights(seed: int, **keys) -> dict:
    """float32 state dict of the small model, drawn from ``seed``:
    matrices N(0, 0.1), the embedding N(0, 1), norm weights around 1, the
    convolutions U(-0.5, 0.5), A = U(1, 16) and dt log-uniform on [1e-3,
    0.1] as the model initialises them, the router's bias N(0, 0.1)."""
    with torch.device("meta"):
        shapes = kl.KimiLinearLM(small_cfg(**keys)).state_dict()
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in shapes.items():
        x = torch.randn(t.shape, generator=g)
        if "norm" in name:
            x = 1.0 + 0.1 * x
        elif name.endswith("A_log"):
            x = torch.empty(t.shape).uniform_(1, 16, generator=g).log()
        elif name.endswith("dt_bias"):
            dt = torch.exp(torch.rand(t.shape, generator=g) * (
                np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
            x = dt + torch.log(-torch.expm1(-dt))
        elif "conv1d" in name:
            x = torch.rand(t.shape, generator=g) - 0.5
        elif not name.startswith("embed"):
            x = 0.1 * x
        out[name] = x
    return out


def model(seed: int, dtype=torch.float32, **keys):
    params = {k: v.to(dtype) if v.dtype == torch.float32 and not (
        k.endswith(("A_log", "dt_bias", "e_score_correction_bias")))
        else v for k, v in weights(seed, **keys).items()}
    return small_cfg(dtype, **keys).serving_model(params, 0, CPU), params


def prompt(seed: int, length: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 500, (length,), generator=g)
    ids[0] = SMALL["bos_token_id"]
    return ids


@pytest.mark.parametrize("chunk", [None, 5, 70])
def test_full_forward_float32_matches_reference(chunk):
    """A 150-token sequence walks three 64-token chunks; ``chunk`` 5 and 70
    cut it across prefill chunks. float32 sums in other orders: 1e-4."""
    m, params = model(1)
    ids = prompt(2, 150)
    with torch.inference_mode():
        got = m(ids, chunk=chunk)
    want = ref.forward(params, SMALL, ids)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("threshold", [ds.ALL_EXPERTS_MAX_TOKENS, 0])
@pytest.mark.parametrize("chunk", [None, 2, 9, 40])
def test_generator_matches_reference_at_every_decoded_position(
        monkeypatch, threshold, chunk):
    """Prefill into the hybrid cache, then cached decode, over a
    LEFT-padded batch of unequal lengths: the logits each step picked from
    equal the reference's full forward over prompt plus emitted tokens.
    ``chunk`` 2 cuts rows into segments shorter than the convolution's
    tail, 9 and 40 cut and pack rows; ``threshold`` 0 sends every forward
    through the grouped experts. float32 throughout: 1e-4."""
    monkeypatch.setattr(ds, "ALL_EXPERTS_MAX_TOKENS", threshold)
    params = weights(3)
    gen = pd.Generator(small_cfg(), params=params, max_prompt_len=80,
                       max_new_tokens=6, device="cpu", prefill_chunk=chunk)
    prompts = [prompt(10, 71).tolist(), prompt(11, 7).tolist(),
               prompt(12, 80).tolist()]
    out = gen.generate_ids(prompts, keep_logits=[0, 1, 2])
    assert out.tokens.shape == (6, 3)
    for r, p in enumerate(prompts):
        toks = out.tokens[:, r]
        seq = torch.cat([torch.tensor(p), toks[:-1]])
        want = ref.forward(params, SMALL, seq)[len(p) - 1:]
        torch.testing.assert_close(out.logits[:, r], want, rtol=1e-4,
                                   atol=1e-4)
        assert (toks == out.logits[:, r].argmax(-1)).all()


@pytest.mark.parametrize("chunk", [None, 9])
def test_generator_keeps_the_kept_rows_routing(monkeypatch, chunk):
    """With ``keep_logits`` the call keeps the router ids that the kept
    rows picked at every real slot, prefill and decode: the ids a forward
    over prompt plus emitted tokens picks, layer by layer; -1 on pad slots
    and past the last step."""
    params = weights(3)
    gen = pd.Generator(small_cfg(), params=params, max_prompt_len=80,
                       max_new_tokens=6, device="cpu", prefill_chunk=chunk)
    prompts = [prompt(10, 71).tolist(), prompt(11, 7).tolist(),
               prompt(12, 80).tolist()]
    out = gen.generate_ids(prompts, keep_logits=[2, 1])
    ids = out.routes.ids
    assert ids.shape == (3, 2, 86, 4) and ids.dtype == torch.int16
    route = ds.MoE.route
    for j, r in enumerate([2, 1]):
        seen = []
        monkeypatch.setattr(ds.MoE, "route", lambda self, x: (
            lambda res: (seen.append(res[0]), res)[1])(route(self, x)))
        seq = torch.cat([torch.tensor(prompts[r]), out.tokens[:-1, r]])
        with torch.inference_mode():
            gen.model(seq)
        monkeypatch.setattr(ds.MoE, "route", route)
        pad = 80 - len(prompts[r])
        assert (ids[:, j, :pad] == -1).all() and (ids[:, j, 85:] == -1).all()
        assert torch.equal(ids[:, j, pad:85].long(), torch.stack(seen))


def _segments_case(seed, dtype, lengths, heads=3, dk=16, dv=8,
                   strength=(0.05, 16.0)):
    """Tokens of ``lengths`` segments packed, each with an initial state,
    gates per step between exp(-strength[1]) and exp(-strength[0])."""
    g = torch.Generator().manual_seed(seed)
    t = sum(lengths)
    q = torch.randn(t, heads, dk, generator=g, dtype=dtype)
    k = ref.l2norm(torch.randn(t, heads, dk, generator=g, dtype=dtype))
    v = torch.randn(t, heads, dv, generator=g, dtype=dtype)
    lo, hi = strength
    gate = -(lo + (hi - lo) * torch.rand(t, heads, dk, generator=g,
                                         dtype=dtype))
    beta = torch.rand(t, heads, generator=g, dtype=dtype)
    s0 = torch.randn(len(lengths), heads, dk, dv, generator=g, dtype=dtype)
    return q, k, v, gate, beta, s0


@pytest.mark.parametrize("strength", [(0.0, 1e-3), (0.05, 3.0),
                                      (8.0, 16.0)])
def test_chunked_twin_matches_the_recurrence_in_float64(strength):
    """The chunked form (``ops/kda.py``: the pairs by halves, the solve,
    the walk's twin) against the token recurrence, in float64, for
    segments of 1, 64, 65 and 150 tokens from initial states: gates near 1,
    moderate, and near e^-16 a step (where a product of exp of positive
    sums would overflow). 1e-10: float64 in two orders."""
    lengths = [1, 64, 65, 150]
    q, k, v, gate, beta, s0 = _segments_case(4, torch.float64, lengths,
                                             strength=strength)
    slot, offsets, n = kda.layout(lengths, CPU)
    heads = q.shape[1]

    def pk(x):
        return _pack64(x.reshape(x.shape[0], -1), slot, n, heads)
    parts = kda.chunk_tensors(
        pk(q).flatten(0, 1), pk(k).flatten(0, 1), pk(v).flatten(0, 1),
        pk(gate).flatten(0, 1), pk(beta).flatten(0, 1)[..., 0])
    shape = (n, heads, kda.CHUNK)
    wu, qt, aqk, kh = (p.view(*shape, -1) for p in parts[:4])
    gam = parts[4].view(n, heads, -1)
    state = s0.clone()
    o = kda.chunk_state_plain(wu, qt, aqk, kh, gam, offsets,
                              list(range(len(lengths))), state)
    got = kda.unpack(o, slot)
    a = 0
    for i, t in enumerate(lengths):
        want, final = ref.kda_recurrence(q[a:a + t], k[a:a + t], v[a:a + t],
                                         gate[a:a + t], beta[a:a + t],
                                         s0[i].clone())
        torch.testing.assert_close(got[a:a + t], want, rtol=1e-10,
                                   atol=1e-10)
        torch.testing.assert_close(state[i], final, rtol=1e-10, atol=1e-10)
        a += t


def _pack64(x, slot, chunks, heads):
    """``kda.pack`` in float64."""
    d = x.shape[-1] // heads
    out = x.new_zeros(chunks * kda.CHUNK, x.shape[-1])
    out.index_copy_(0, slot, x)
    return out.view(chunks, kda.CHUNK, heads, d).transpose(1, 2).contiguous()


def test_a_row_cut_across_prefill_chunks_carries_state_and_tail():
    """One row prefilled in chunks of 2, 3 and 64 tokens gives the logits
    and the hybrid cache (state, tails, latent) of the row prefilled
    whole; dropping the carried tail, or the carried state, between chunks
    changes the logits."""
    m, _ = model(5)
    ids = prompt(6, 101)[None]
    pad = torch.zeros(1, dtype=torch.long)
    with torch.inference_mode():
        whole, c0 = m.prefill(ids, pad, None, None, 101)
        for chunk in (2, 3, 64):
            got, c1 = m.prefill(ids, pad, None, None, 101, chunk=chunk)
            torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)
            for a, b in ((c1.state, c0.state), (c1.tail, c0.tail),
                         (c1.buf, c0.buf)):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for part in ("tail", "state"):
        plain = m._chunk

        def dropped(ids_, cache, segs, probe=None, part=part):
            if segs[0][2] > segs[0][1]:
                getattr(cache, part).zero_()
            return plain(ids_, cache, segs, probe)
        m._chunk = dropped
        with torch.inference_mode():
            got, _ = m.prefill(ids, pad, None, None, 101, chunk=64)
        m._chunk = plain
        assert float((got - whole).abs().max()) > 1e-3, part


def test_sigmoid_router_picks_by_bias_and_weighs_without_it():
    """Top-k on sigmoid scores plus the correction bias; weights the
    unbiased scores, renormalised to sum to routed_scaling_factor."""
    m, params = model(7)
    moe = m.layers[1].mlp
    x = torch.randn(37, 64, generator=torch.Generator().manual_seed(8))
    with torch.inference_mode():
        idx, w = moe.route(x)
    p = ref.sub(params, "layers.1.mlp.")
    want_idx, want_w = ref.route(p, SMALL, x)
    assert (idx.sort(-1).values == want_idx.sort(-1).values).all()
    torch.testing.assert_close(w.sum(-1), torch.full((37,), 2.446))
    order = idx.argsort(-1)
    torch.testing.assert_close(w.gather(1, order),
                               want_w.gather(1, want_idx.argsort(-1)))
    with torch.no_grad():
        moe.gate.e_score_correction_bias[3] = 10.0
        assert (moe.route(x)[0] == 3).any(-1).all()


@pytest.mark.parametrize("threshold", [ds.ALL_EXPERTS_MAX_TOKENS, 0])
def test_expert_shares_sum_to_the_whole_layer(monkeypatch, threshold):
    """The four ranks' MoE layers (4 experts each of a router over 16),
    their routed parts summed and the shared expert counted once, give
    the layer that holds all 16; each share equals the reference's."""
    monkeypatch.setattr(ds, "ALL_EXPERTS_MAX_TOKENS", threshold)
    whole_keys = dict(num_experts=16, expert_parallel=None)
    mw, pw = model(9, **whole_keys)
    x = torch.randn(41, 64, generator=torch.Generator().manual_seed(10))
    with torch.inference_mode():
        want = mw.layers[2].mlp(x)
        shared = mw.layers[2].mlp.shared_experts(x)
    total = shared.clone()
    for rank in range(4):
        keys = dict(num_experts=4, expert_parallel={"ranks": 4,
                                                    "rank": rank})
        params = {}
        for k, v in pw.items():
            if "mlp.experts." in k and k.startswith("layers.2."):
                v = v[4 * rank:4 * rank + 4]
            elif "mlp.experts." in k:
                v = v[:4]
            params[k] = v
        m = small_cfg(**keys).serving_model(params, 0, CPU)
        with torch.inference_mode():
            part = m.layers[2].mlp(x)
        p = ref.sub(params, "layers.2.mlp.")
        torch.testing.assert_close(part, ref.moe(p, dict(SMALL, **keys), x),
                                   rtol=1e-5, atol=1e-5)
        total += part - shared
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)


# DeepSeek-V2-Lite's small model through the same Generator calls, one
# thread, float32 and bfloat16, every expert over every token and grouped:
# the logits hash as they did before Kimi Linear shared its MoE and MLA.
_V2_LOGITS = ["539ef3517ca713df", "b2693a13068945ef", "8e30132988c15503",
              "8e30132988c15503"]


def test_deepseek_v2_lite_logits_are_unchanged(monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_deepseek_v2 as t
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    got = []
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for threshold in (128, 0):
                monkeypatch.setattr(ds, "ALL_EXPERTS_MAX_TOKENS", threshold)
                params = {k: v.to(dtype) for k, v in t.weights(31).items()}
                gen = pd.Generator(t.small_cfg(dtype), params=params,
                                   max_prompt_len=16, max_new_tokens=5,
                                   device="cpu", prefill_chunk=6)
                res = gen.generate_ids(
                    [t.prompt(40, 13).tolist(), t.prompt(41, 7).tolist(),
                     t.prompt(42, 16).tolist()], keep_logits=[0, 1, 2])
                got.append(hashlib.sha256(
                    res.logits.float().numpy().tobytes()).hexdigest()[:16])
    finally:
        torch.set_num_threads(threads)
    assert got == _V2_LOGITS


def test_published_configuration_and_its_share():
    """49,122,763,648 weights whole; 13,789,946,752 in rank 0's share of 64
    experts a layer; the hybrid cache of the cell (B = 32, 32,768 + 128
    slots): 8.49 GB of latent cache in 7 layers, 1.34 GB of KDA state in
    20, tails of 3 inputs."""
    cat = {k: v for k, v in PUBLISHED.items() if k != "expert_parallel"}
    whole = kl.KimiLinearConfig.from_config(dict(cat, num_experts=256))
    cfg = kl.KimiLinearConfig.from_config(PUBLISHED)
    assert (cfg.num_experts, cfg.held, cfg.expert_first) == (256, 64, 0)
    assert whole.held == 256 and cfg.mla_layers == [3, 7, 11, 15, 19, 23,
                                                     26]
    for c, n in ((whole, 49_122_763_648), (cfg, 13_789_946_752)):
        with torch.device("meta"):
            lm = kl.KimiLinearLM(c)
        assert sum(p.numel() for p in lm.parameters()) == n
    cache = lm.new_cache(32, 32896, "meta")
    assert cache.buf.shape == (7, 32, 32896, 576)
    assert cache.state.shape == (20, 32, 32, 128, 128)
    assert cache.tail.shape == (20, 32, 3, 3 * 4096)
    sizes = cache.byte_sizes()
    assert sizes["latent_bytes"] == 7 * 32 * 32896 * 576 * 2
    assert sizes["state_bytes"] == (20 * 32 * 32 * 128 * 128 * 4
                                    + 20 * 32 * 3 * 12288 * 2)


@pytest.mark.parametrize("key,value", [
    ("mla_use_nope", False), ("moe_router_activation_func", "softmax"),
    ("num_expert_group", 8), ("rope_scaling", {"type": "yarn"})])
def test_from_config_refuses_what_it_does_not_implement(key, value):
    with pytest.raises(ValueError, match=key):
        kl.KimiLinearConfig.from_config(dict(PUBLISHED, **{key: value}))


def test_generation_spans_and_counters():
    """With a profiler session on, ``generate`` records the hybrid cache's
    bytes; ``generate.prefill`` the tokens of the 4 held experts a MoE
    layer, the picks of the 12 absent ones (4 picks a real token, in
    all), and the chunks the KDA layers walked; ``generate.decode`` the
    held experts hit a step."""
    gen = pd.Generator(small_cfg(), params=weights(11), max_prompt_len=70,
                       max_new_tokens=3, device="cpu", prefill_chunk=40)
    prompts = [prompt(20, 9).tolist(), prompt(21, 70).tolist()]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        gen.generate_ids(prompts)
    recs = {r.name: r for r in profiling.RECORDER.records(t0)}
    top, pre, dec = (recs[n] for n in ("generate", "generate.prefill",
                                       "generate.decode"))
    assert top.attrs["latent_bytes"] == 1 * 2 * 73 * 40 * 4
    assert top.attrs["state_bytes"] == (3 * 2 * 2 * 16 * 16 * 4
                                        + 3 * 2 * 3 * 96 * 4)
    counts = np.asarray(pre.attrs["expert_tokens"])
    assert counts.shape == (3, 4)
    assert counts.sum() + pre.attrs["remote_picks"] == 3 * 79 * 4
    # chunks of 40: [70 row: 40] [its 30 + the 9 row] -> 1 + 2 chunks of 64
    # a layer, 3 KDA layers
    assert pre.attrs["kda_chunks"] == 3 * 3
    hit = np.asarray(dec.attrs["experts_hit"])
    assert hit.shape == (2, 3) and ((hit >= 0) & (hit <= 4)).all()
