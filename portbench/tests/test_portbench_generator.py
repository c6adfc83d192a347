"""The generator kind (``systems/generator.py``) and its cell, shrunk to a
small model on the CPU: hidden 64, 4 heads, qk_nope 16, qk_rope 8, v 16,
kv_lora 32, 3 layers (1 dense), 8 experts top-2 plus 2 shared, vocabulary
512; prompts of 8-20 tokens, 4 new tokens, batches of 3."""

import os
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import control, harness, spans as spans_mod
from portbench.reference.deepseek_v2 import Reference, param_shapes
from portbench.systems import generator, generator_work as gw

CELL = "deepseek-v2-lite.bf16.rag-b32-16k"
SEED = 2 ** 31 + 17
TESTS = os.path.join(harness.ROOT, "tests")
SMALL = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=24,
             num_hidden_layers=3, num_attention_heads=4,
             num_key_value_heads=4, n_routed_experts=8, n_shared_experts=2,
             num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, vocab_size=512,
             bos_token_id=500, eos_token_id=501, initializer_range=0.2,
             generator={"max_prompt_len": 24, "max_new_tokens": 4,
                        "prefill_chunk": 8})


# The cell's limits are set at the published size on the card. The small
# model's bf16 rounding reads other numbers (6 seeds: score_err 0.023-0.112,
# logit_err_med 0.017-0.024, rank_gap 0-0.104; the control 0.34-0.82,
# 0.20-0.40, 0.62-3.50), so the shrunk cell takes limits of its own.
SMALL_LIMITS = {"missing": 0, "score_err": 0.2, "logit_err_med": 0.1,
                "rank_gap": 0.5}


def small_cell():
    c = harness.cell(harness.benchmark(), CELL)
    c.cfg.update(SMALL)
    c.mix.update(batch=3, min_len=8, max_len=20, new_tokens=4, pool=2,
                 warm_new_tokens=2, max_id=499)
    c.limits = dict(SMALL_LIMITS)
    return c


def run(c, monkeypatch, metrics=()):
    torch.set_num_threads(4)
    return harness.run_cell(c, SEED, 0.2, False, "cpu", time.perf_counter(),
                            list(metrics))


def test_the_cell_runs_and_is_correct(monkeypatch):
    out = run(small_cell(), monkeypatch, [{"name": "setup_s", "unit": "s"},
                                          {"name": "batch_qps",
                                           "unit": "queries/s"}])
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"missing", "score_err", "rank_gap",
                                  "logit_err_med"}
    assert out["attempted"] >= 3 and out["failed"] == 0
    assert out["metrics"]["batch_qps"]["value"] > 0
    assert out["_notes"]["setup_phases_s"]["weights"] >= 0


def test_a_perturbed_expert_is_not_correct(monkeypatch):
    init = generator.System.__init__

    def planted(self, *a, **kw):
        init(self, *a, **kw)
        with torch.no_grad():
            self.generator.model.layers[1].mlp.experts.gate_up_proj[3] *= 1.5
    monkeypatch.setattr(generator.System, "__init__", planted)
    out = run(small_cell(), monkeypatch)
    assert not out["correct"], out["checks"]


def test_dropped_shared_experts_are_not_correct(monkeypatch):
    from optimized_rag_tpu_torch.models import deepseek_v2 as ds
    monkeypatch.setattr(ds.MoE, "forward", lambda self, x, note=None:
                        self.experts.every(
                            x, *self.route(x)).to(x.dtype))
    out = run(small_cell(), monkeypatch)
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct():
    res = control.run(small_cell(), SEED, "cpu", 3)
    assert set(res["numbers"]) == {"missing", "score_err", "rank_gap",
                                   "logit_err_med"}
    assert not res["correct"], res["numbers"]


def test_the_reference_copy_agrees_with_the_tests_reference():
    sys.path.insert(0, TESTS)
    try:
        import deepseek_v2_reference as tests_ref
    finally:
        sys.path.remove(TESTS)
    cfg = dict(harness.cell(harness.benchmark(), CELL).cfg, **SMALL)
    params = {n: generator.draw(cfg, n, s, SEED, "cpu").float()
              for n, s in param_shapes(cfg).items()}
    ids = [torch.randint(0, 500, (n,), generator=torch.Generator(
        ).manual_seed(n)) for n in (17, 9)]
    got = Reference(cfg, params.__getitem__, "cpu", block=5).logits(
        ids, [torch.arange(len(i)) for i in ids])
    for i, g in zip(ids, got):
        torch.testing.assert_close(g, tests_ref.forward(params, cfg, i),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the readers


def rec(name, rid, parent, t0, t1, **attrs):
    return SimpleNamespace(name=name, id=rid, parent=parent,
                           start_ns=int(t0 * 1e9), end_ns=int(t1 * 1e9),
                           attrs=attrs)


def hand_run(monkeypatch):
    """A window [10, 20) s with one call: 2 rows of 3 and 5 real tokens
    in P = 6, 2 decode steps; a MoE layer of 4 experts."""
    recs = [rec("generate", 1, None, 10.0, 15.0, B=2, P=6, prompt_tokens=8,
                new_tokens=3, steps=2),
            rec("generate.prefill", 2, 1, 10.1, 12.0, chunks=2, tokens=8,
                real=8, device_ms=1500.0,
                expert_tokens=[[4, 2, 1, 1], [2, 2, 2, 2]]),
            rec("generate.decode", 3, 1, 12.0, 14.0, steps=2,
                device_ms=40.0, experts_hit=[[3], [4]]),
            rec("generate", 4, None, 25.0, 26.0, B=2, P=6)]
    from optimized_rag_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling.RECORDER, "records",
                        lambda t0, t1=None: [r for r in recs
                                             if r.start_ns >= t0 * 1e9])
    cfg = dict(harness.cell(harness.benchmark(), CELL).cfg,
               **dict(SMALL, n_routed_experts=4, num_hidden_layers=2))
    pool = torch.zeros(1, 2, 6, dtype=torch.long)
    out = SimpleNamespace(tokens=torch.zeros(3, 2, dtype=torch.long))
    load = SimpleNamespace(calls=[(0, 10.0, 15.0, out)], pool=pool,
                           pad=torch.tensor([[3, 1]]), t0=10.0, t1=20.0)
    return harness.Run(cell=SimpleNamespace(cfg=cfg), load=load, t0=10.0,
                       t1=20.0, trace=None, system=None)


@pytest.mark.parametrize("name,want", [
    ("prefill_ms.gen", 1500.0),
    ("decode_step_ms.gen", 20.0),
    ("expert_load_max.gen", (2.0 + 1.0) / 2),
    ("prefill_pad_share.gen", 0.0),
])
def test_readers_on_hand_made_records(monkeypatch, name, want):
    assert harness.reader(name)(hand_run(monkeypatch)) == pytest.approx(want)


def test_roofline_and_mfu_readers_on_hand_made_records(monkeypatch):
    r = hand_run(monkeypatch)
    cfg = r.cell.cfg
    least = (gw.decode_step_bound_ms(cfg, [3], 2, 8 + 2)
             + gw.decode_step_bound_ms(cfg, [4], 2, 8 + 4))
    assert harness.reader("decode_roofline.gen")(r) == pytest.approx(
        100 * least / 40.0)
    flops = (gw.prefill_flops(cfg, [3, 5]) + gw.decode_step_flops(cfg, 2, 10)
             + gw.decode_step_flops(cfg, 2, 12))
    assert harness.reader("mfu.gen")(r) == pytest.approx(
        100 * flops / 989e12 / 10.0)


def test_readers_find_nothing_without_the_programs_records(monkeypatch):
    r = hand_run(monkeypatch)
    from optimized_rag_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling.RECORDER, "records", lambda *a: [])
    for name in ("prefill_ms.gen", "decode_step_ms.gen",
                 "decode_roofline.gen", "expert_load_max.gen",
                 "prefill_pad_share.gen", "idle_share.gen"):
        assert harness.reader(name)(r) is None, name


def test_work_counts_at_the_published_size():
    """15,706,484,224 weights; 2.34 PFLOP of real prefill for the cell's
    ladder of lengths (3.54 if every prompt were 16,384)."""
    from portbench.traffic.generate import ladder
    c = harness.cell(harness.benchmark(), CELL)
    assert gw.total_params(c.cfg) == 15_706_484_224
    lengths = ladder(c.mix).tolist()
    assert lengths[0] >= 8192 and lengths[-1] <= 16384
    assert gw.prefill_flops(c.cfg, lengths) == pytest.approx(2.338e15,
                                                             rel=1e-3)
    assert gw.prefill_flops(c.cfg, [16384] * 32) == pytest.approx(
        3.538e15, rel=1e-3)


def test_phase_spans_name_the_idle_gaps(monkeypatch):
    """The kind turns the program's prefill and decode records of a call
    into host spans of those layers."""
    sysm = SimpleNamespace(spans=spans_mod.Spans(), generator=SimpleNamespace(
        generate_ids=lambda *a, **kw: "out"))
    t = time.perf_counter()
    recs = [rec("generate.prefill", 1, 0, t + 1, t + 2),
            rec("generate.decode", 2, 0, t + 2, t + 3),
            rec("generate.prefill", 3, 0, t - 5, t - 4)]
    from optimized_rag_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling.RECORDER, "records",
                        lambda t0, t1=None: [r for r in recs
                                             if r.start_ns >= t0 * 1e9])
    assert generator.System.generate(sysm, None, None, 1) == "out"
    assert [round(s[0] - t) for s in sysm.spans.prefill] == [1]
    assert [round(s[0] - t) for s in sysm.spans.decode] == [2]
