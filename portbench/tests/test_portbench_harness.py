"""BENCHMARK.json against the contract's shape, and the harness finding a
configuration, a mix, a metric's reader and a cell's limits by name."""

import json
import os
import re

import pytest

from portbench import harness

B = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in B["end_to_end"]}
CELLS = [w["name"] for w in B["workloads"]]


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(B)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = [x["name"] for part in ("configs", "workloads", "end_to_end",
                                    "per_layer") for x in B[part]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        E2E["setup_s"]


def test_reduced_keys_are_changed_and_no_width():
    for c in B["configs"]:
        cfg = harness.load_json(harness.ROOT, c["file"])
        for key in c["reduced"]:
            assert key in cfg and cfg[key] != cfg["source_values"][key]
            assert not key.endswith(("_dim", "_rank", "_size")) or \
                key == "vocab_size"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in harness.metrics_for(B, cell, "end_to_end")]
    layer = harness.metrics_for(B, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_harness_finds_each_part_by_name(cell):
    c = harness.cell(B, cell)
    assert c.cfg["name"] == next(w["config"] for w in B["workloads"]
                                 if w["name"] == cell)
    assert os.path.exists(os.path.join(
        harness.HERE, "traffic", c.mix["generator"] + ".py"))
    assert set(c.limits) >= {"missing", "score_err", "rank_gap"}
    for section in ("end_to_end", "per_layer"):
        for m in harness.metrics_for(B, cell, section):
            assert callable(harness.reader(m["name"]))


def test_unknown_workload_is_refused():
    with pytest.raises(harness.Refused):
        harness.cell(B, "no-such-cell")
