"""The comparison that decides ``correct``, at a size the CPU holds: the
program passes, the control (the reference one step below the stated
precision) fails, and a run whose timed path is broken underneath fails.

Each run goes through ``harness.run_cell`` past its look for a card. The
faults a retrieval cell can have: half of a batch's answers left out (the
second half given the first half's), and an answer altered where it is
produced (one id of each batch moved to another row, its score kept). A
state left unchanged (training) and the exchange between chips (four
chips) do not arise in these cells.
"""

import time

import numpy as np
import pytest

from portbench import control, harness

CELLS = ["mrl128.bf16-10m.batch-b4096", "minilm-l6.f32-4m.search-saturated"]


def run(c):
    return harness.run_cell(c, 2 ** 31 + 101, 1.5, False, "cpu",
                            time.perf_counter(), [])


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(tiny_cell, cell):
    out = run(tiny_cell(cell))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_cell, cell):
    res = control.run(tiny_cell(cell), 2 ** 31 + 5, "cpu", 256)
    assert not res["correct"], res["numbers"]


def half_left_out(res):
    b = res.ids.shape[0]
    h = b // 2
    if h:
        res.ids[h:2 * h] = res.ids[:h]
        res.scores[h:2 * h] = res.scores[:h]
    return res


def answer_altered(res):
    res.ids[0, 0] = (res.ids[0, 0] + 1) % 65536
    return res


@pytest.mark.parametrize("fault", [half_left_out, answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, cell,
                                          fault):
    from optimized_rag_tpu_torch.index.dense import DenseIndex
    search = DenseIndex.search
    monkeypatch.setattr(DenseIndex, "search", lambda self, *a, **k: fault(
        search(self, *a, **k)))
    out = run(tiny_cell(cell))
    assert not out["correct"], out["checks"]
    assert np.isfinite(out["checks"]["score_err"]["value"])
