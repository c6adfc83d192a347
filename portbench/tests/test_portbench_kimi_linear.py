"""The Kimi Linear kind (``systems/kimi_linear.py``) and its cell, shrunk to
a small model on the CPU: hidden 64, one period of the layer pattern (3
KDA layers of 2 heads of 16, then a NoPE MLA layer of 4 heads, qk_nope 16,
qk_rope 8, v 16, kv_lora 32), a dense first layer, a router over 16
experts top-4 of which rank 0 holds 4, 1 shared expert, vocabulary 512;
prompts of 8-90 tokens (KDA walks up to two chunks of 64), prefill chunks
of 40, 4 new tokens, batches of 3."""

import dataclasses
import os
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import control, harness
from portbench.reference import kimi_linear as R
from portbench.systems import kimi_linear as kind, kimi_linear_work as kw

CELL = "kimi-linear-48b-a3b.ep4.bf16.rag-b32-32k"
SEED = 2 ** 31 + 29
TESTS = os.path.join(harness.ROOT, "tests")
SMALL = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=24,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, vocab_size=512,
             num_experts=4, num_experts_per_token=4,
             bos_token_id=500, eos_token_id=501, initializer_range=0.2,
             linear_attn_config={"full_attn_layers": [4],
                                 "kda_layers": [1, 2, 3], "head_dim": 16,
                                 "num_heads": 2, "short_conv_kernel_size": 4},
             generator={"max_prompt_len": 90, "max_new_tokens": 4,
                        "prefill_chunk": 40})

# The cell's limits are set at the published size on the card. The small
# model's bf16 rounding reads other numbers (3 seeds: score_err
# 0.027-0.040, logit_err_med 0.015-0.021, rank_gap 0-0.076, route_gap
# 0.006-0.038; the fp8 control 0.24-0.66, 0.19-0.25, 0.20-1.07,
# 0.29-0.42), so the shrunk cell takes limits of its own.
SMALL_LIMITS = {"missing": 0, "score_err": 0.1, "logit_err_med": 0.05,
                "rank_gap": 0.25, "route_gap": 0.1}
NUMBERS = set(SMALL_LIMITS)


def small_cell():
    c = harness.cell(harness.benchmark(), CELL)
    c.cfg.update(SMALL)
    c.mix.update(batch=3, min_len=8, max_len=90, new_tokens=4, pool=2,
                 warm_new_tokens=2, max_id=499)
    c.limits = dict(SMALL_LIMITS)
    return c


def run(metrics=()):
    torch.set_num_threads(4)
    return harness.run_cell(small_cell(), SEED, 0.2, False, "cpu",
                            time.perf_counter(), list(metrics))


def test_the_cell_runs_and_is_correct():
    out = run([{"name": "setup_s", "unit": "s"},
               {"name": "batch_qps", "unit": "queries/s"}])
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == NUMBERS
    assert out["attempted"] >= 3 and out["failed"] == 0
    assert out["metrics"]["batch_qps"]["value"] > 0


def _after_prefill(monkeypatch, fault):
    from optimized_rag_tpu_torch.models import kimi_linear as kl
    prefill = kl.KimiLinearLM.prefill

    def planted(self, *a, **kw):
        logits, cache = prefill(self, *a, **kw)
        fault(cache)
        return logits, cache
    monkeypatch.setattr(kl.KimiLinearLM, "prefill", planted)


def _rope_on_nope(monkeypatch):
    """RoPE turns q_pe and k_pe of the NoPE MLA layers (at each row's index
    in the forward)."""
    from optimized_rag_tpu_torch.models import deepseek_v2 as ds
    project = ds.MLA._project

    def planted(self, h, cos, sin):
        q_nope, q_pe, lat = project(self, h, cos, sin)
        if cos is None:
            cfg = dataclasses.replace(self.cfg, mla_use_nope=False)
            cos, sin = ds.rope_cos_sin(cfg, torch.arange(
                h.shape[0], device=h.device))
            r = cfg.kv_lora_rank
            q_pe = ds.apply_rope(q_pe, cos[:, None], sin[:, None])
            lat = torch.cat([lat[:, :r], ds.apply_rope(lat[:, r:], cos, sin)],
                            -1)
        return q_nope, q_pe, lat
    monkeypatch.setattr(ds.MLA, "_project", planted)


def _no_bias(monkeypatch):
    """The router picks on the sigmoid scores alone."""
    from optimized_rag_tpu_torch.models import deepseek_v2 as ds
    route = ds.MoE.route

    def planted(self, x):
        bias = self.gate.e_score_correction_bias
        self.gate.e_score_correction_bias = torch.nn.Parameter(
            torch.zeros_like(bias), requires_grad=False)
        try:
            return route(self, x)
        finally:
            self.gate.e_score_correction_bias = bias
    monkeypatch.setattr(ds.MoE, "route", planted)


def _walk_bf16(wu, qt, aqk, kh, gam, offsets, rows, state):
    """``kda.chunk_state_plain`` with the state rounded to bfloat16 after
    every chunk."""
    w, u = wu.split([qt.shape[-1], state.shape[-1]], dim=-1)
    o = torch.empty_like(u)
    for i, row in enumerate(rows):
        s = state[row].clone()
        for n in range(offsets[i], offsets[i + 1]):
            un = u[n] - w[n] @ s
            o[n] = qt[n] @ s + aqk[n] @ un
            s = gam[n][..., None] * s + kh[n].transpose(-1, -2) @ un
            s = s.to(torch.bfloat16).float()
        state[row] = s
    return o


def _bf16_state(monkeypatch):
    """The KDA state kept in bfloat16, a precision below the float32 the
    configuration states: rounded after every chunk of the prefill's walk
    (which then runs in torch) and after every decode step."""
    from optimized_rag_tpu_torch.models import kimi_linear as kl
    from optimized_rag_tpu_torch.ops import kda
    decode = kl.KDA.decode

    def planted(self, h, state, tail):
        o = decode(self, h, state, tail)
        state.copy_(state.to(torch.bfloat16))
        return o
    monkeypatch.setattr(kda, "chunk_state", _walk_bf16)
    monkeypatch.setattr(kl.KDA, "decode", planted)


FAULTS = {
    "state_zeroed": lambda mp: _after_prefill(mp, lambda c: c.state.zero_()),
    "tail_dropped": lambda mp: _after_prefill(mp, lambda c: c.tail.zero_()),
    "rope_on_nope": _rope_on_nope,
    "bias_ignored": _no_bias,
    "bf16_state": _bf16_state,
}


# The bf16 state reads as the program does at this size (prompts of at most
# 90 tokens and 4 steps leave the rounding no time to grow); the cell's
# runs on the card hold it.
@pytest.mark.parametrize("fault", ["state_zeroed", "tail_dropped",
                                   "rope_on_nope", "bias_ignored"])
def test_planted_faults_are_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]


def test_a_program_that_keeps_no_routing_is_not_correct(monkeypatch):
    """Without the program's routing the check has no ``route_gap``, and
    a verdict without it fails."""
    from optimized_rag_tpu_torch.models import kimi_linear as kl
    monkeypatch.setattr(kl.KimiLinearLM, "keeps_routes", False)
    out = run()
    assert not out["correct"]
    assert set(out["checks"]) == NUMBERS - {"route_gap"}


def test_the_control_is_not_correct():
    res = control.run(small_cell(), SEED, "cpu", 3)
    assert set(res["numbers"]) == NUMBERS
    assert not res["correct"], res["numbers"]


def test_the_reference_copy_agrees_with_the_tests_reference():
    """The card's reference (KDA chunked with pairwise decays, MLA in
    blocks of queries) against the tests' (KDA token by token) on two
    sequences, one over two KDA chunks."""
    sys.path.insert(0, TESTS)
    try:
        import kimi_linear_reference as tests_ref
    finally:
        sys.path.remove(TESTS)
    cfg = dict(harness.cell(harness.benchmark(), CELL).cfg, **SMALL)
    params = {n: kind.draw(cfg, n, s, SEED, "cpu").float()
              for n, s in R.param_shapes(cfg).items()}
    ids = [torch.randint(0, 500, (n,), generator=torch.Generator(
        ).manual_seed(n)) for n in (97, 9)]
    got = R.Reference(cfg, params.__getitem__, "cpu", block=5).logits(
        ids, [torch.arange(len(i)) for i in ids])
    for i, g in zip(ids, got):
        torch.testing.assert_close(g, tests_ref.forward(params, cfg, i),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("strength", [(0.0, 1e-3), (8.0, 16.0)])
def test_the_reference_chunked_form_matches_the_recurrence(strength):
    """``kda_chunked`` (pairwise decays, chunks of 64) against the token
    recurrence in float64 over 150 tokens from a state, gates near 1 and
    near e^-16 a step: 1e-10."""
    sys.path.insert(0, TESTS)
    try:
        import kimi_linear_reference as tests_ref
    finally:
        sys.path.remove(TESTS)
    g = torch.Generator().manual_seed(3)
    f64 = torch.float64
    q = torch.randn(150, 2, 16, generator=g, dtype=f64)
    k = tests_ref.l2norm(torch.randn(150, 2, 16, generator=g, dtype=f64))
    v = torch.randn(150, 2, 8, generator=g, dtype=f64)
    lo, hi = strength
    gate = -(lo + (hi - lo) * torch.rand(150, 2, 16, generator=g, dtype=f64))
    beta = torch.rand(150, 2, generator=g, dtype=f64)
    s0 = torch.randn(2, 16, 8, generator=g, dtype=f64)
    o, s = R.kda_chunked(q, k, v, gate, beta, s0.clone(), chunks_at_once=2)
    want, final = tests_ref.kda_recurrence(q, k, v, gate, beta, s0.clone())
    torch.testing.assert_close(o, want, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(s, final, rtol=1e-10, atol=1e-10)


def test_param_shapes_are_the_models_own():
    from optimized_rag_tpu_torch.models.kimi_linear import (
        KimiLinearConfig, KimiLinearLM)
    cfg = harness.cell(harness.benchmark(), CELL).cfg
    with torch.device("meta"):
        lm = KimiLinearLM(KimiLinearConfig.from_config(cfg))
    assert {k: tuple(v.shape) for k, v in lm.state_dict().items()} == \
        R.param_shapes(cfg)


def test_work_counts_at_the_published_size():
    """13,789,946,752 weights in the share; the ladder of 32 prompts of
    8-32K tokens holds about 567K real tokens and 2.7 PFLOP of prefill
    (KDA's chunked form about 0.1 PFLOP of it)."""
    from portbench.traffic.generate import ladder
    c = harness.cell(harness.benchmark(), CELL)
    assert kw.total_params(c.cfg) == 13_789_946_752
    lengths = ladder(c.mix).tolist()
    assert lengths[0] >= 8192 and lengths[-1] <= 32768
    assert sum(lengths) == pytest.approx(567_000, rel=0.01)
    assert kw.prefill_flops(c.cfg, lengths) == pytest.approx(2.7e15,
                                                             rel=0.05)
    assert kw.expected_picks(c.cfg) == 2.0


# ------------------------------------------------------------ the readers


def rec(name, rid, parent, t0, t1, **attrs):
    return SimpleNamespace(name=name, id=rid, parent=parent,
                           start_ns=int(t0 * 1e9), end_ns=int(t1 * 1e9),
                           attrs=attrs)


def hand_run(monkeypatch):
    """A window [10, 20) s with one call: 2 rows of 3 and 5 real tokens
    in P = 6, 2 decode steps; 3 MoE layers of 4 held experts; the KDA
    kernel 2 ms on the device; 5 s of 10 busy."""
    recs = [rec("generate", 1, None, 10.0, 15.0, B=2, P=6, prompt_tokens=8,
                new_tokens=3, steps=2, latent_bytes=100, state_bytes=50),
            rec("generate.prefill", 2, 1, 10.1, 12.0, chunks=1, tokens=8,
                real=8, device_ms=1500.0, remote_picks=20, kda_chunks=6,
                expert_tokens=[[4, 2, 1, 1], [2, 2, 2, 2], [1, 1, 1, 1]]),
            rec("generate.decode", 3, 1, 12.0, 14.0, steps=2,
                device_ms=40.0, experts_hit=[[3, 1, 2], [4, 2, 2]]),
            rec("generate", 4, None, 25.0, 26.0, B=2, P=6)]
    from optimized_rag_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling.RECORDER, "records",
                        lambda t0, t1=None: [r for r in recs
                                             if r.start_ns >= t0 * 1e9])
    cfg = dict(harness.cell(harness.benchmark(), CELL).cfg, **SMALL)
    pool = torch.zeros(1, 2, 6, dtype=torch.long)
    out = SimpleNamespace(tokens=torch.zeros(3, 2, dtype=torch.long))
    load = SimpleNamespace(calls=[(0, 10.0, 15.0, out)], pool=pool,
                           pad=torch.tensor([[3, 1]]), t0=10.0, t1=20.0)
    trace = {"window_ns": 10e9, "busy_ns": 5e9, "by_name_ns": {
        "void kda::chunk_state_kernel(float const*)": 2e6, "gemm": 3e9}}
    return harness.Run(cell=SimpleNamespace(cfg=cfg), load=load, t0=10.0,
                       t1=20.0, trace=trace, system=None)


@pytest.mark.parametrize("name,want", [
    ("prefill_ms.kl", 1500.0),
    ("decode_step_ms.kl", 20.0),
    ("expert_load_max.kl", (2.0 + 1.0 + 1.0) / 3),
    ("idle_share.kl", 50.0),
])
def test_readers_on_hand_made_records(monkeypatch, name, want):
    assert harness.reader(name)(hand_run(monkeypatch)) == pytest.approx(want)


def test_roofline_and_mfu_readers_on_hand_made_records(monkeypatch):
    r = hand_run(monkeypatch)
    cfg = r.cell.cfg
    least = (kw.decode_step_bound_ms(cfg, [3, 1, 2], 2, 8 + 2)
             + kw.decode_step_bound_ms(cfg, [4, 2, 2], 2, 8 + 4))
    assert harness.reader("decode_roofline.kl")(r) == pytest.approx(
        100 * least / 40.0)
    flops = (kw.prefill_flops(cfg, [3, 5]) + kw.decode_step_flops(cfg, 2, 10)
             + kw.decode_step_flops(cfg, 2, 12))
    assert harness.reader("mfu.kl")(r) == pytest.approx(
        100 * flops / 989e12 / 10.0)
    walk = 3 * kw.kda_walk_bound_ms(cfg, [3, 5])
    assert harness.reader("kda_roofline.kl")(r) == pytest.approx(
        100 * walk / 2.0)


def test_readers_find_nothing_without_the_programs_records(monkeypatch):
    r = hand_run(monkeypatch)
    from optimized_rag_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling.RECORDER, "records", lambda *a: [])
    for name in ("prefill_ms.kl", "decode_step_ms.kl", "decode_roofline.kl",
                 "expert_load_max.kl"):
        assert harness.reader(name)(r) is None, name
    r.trace["by_name_ns"] = {"gemm": 3e9}
    assert harness.reader("kda_roofline.kl")(r) is None
    r.trace = None
    assert harness.reader("kda_roofline.kl")(r) is None
    assert harness.reader("idle_share.kl")(r) is None


def main(argv=None) -> int:
    """The cell at its published size on the card with a fault planted:
    prints the run's ``correct`` and the numbers compared, a JSON line a
    seed.

        python3 -m portbench.tests.test_portbench_kimi_linear \\
            --fault bf16_state --seeds 1 2
    """
    import argparse
    import json
    p = argparse.ArgumentParser()
    p.add_argument("--fault", choices=sorted(FAULTS), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args(argv)
    c = harness.cell(harness.benchmark(), CELL)
    for seed in a.seeds:
        with pytest.MonkeyPatch.context() as mp:
            FAULTS[a.fault](mp)
            out = harness.run_cell(c, seed, a.seconds, False, "cuda",
                                   time.perf_counter(), [])
        print(json.dumps({"fault": a.fault, "seed": seed,
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
