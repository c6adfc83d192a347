"""Kinds of system (``portbench/systems/``): a configuration names its kind,
and the harness, the trace and the control find the kind's code by that
name.

A toy kind, put in as a module from this file alone, runs a whole cell
through ``harness.run_cell``; the retrieval kind gives what the check gave
before kinds existed; a configuration that names no kind is refused.
"""

import json
import os
import re
import subprocess
import sys
import time
import types
from types import SimpleNamespace

import pytest
import torch

from portbench import check, control, harness, spans as spans_mod
from portbench.systems import retrieval
from portbench.trace import reduce

B = harness.benchmark()
TOY = "portbench.systems.toy_matmul"
TOY_MIX = "portbench.traffic.toy_calls"
DIM = 32

# ------------------------------------------------------------------ the toy
# A "system" that multiplies query rows by a square matrix it makes from the
# seed, one call a batch, and records each call as a span of its own layer
# ("matmul"). Its traffic calls it back to back; its reference makes the
# matrix again in float64.


def toy_weights(seed: int, dtype) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(DIM, DIM, generator=g, dtype=torch.float64).to(dtype)


class ToySystem:
    def __init__(self, cfg, seed, device, spans):
        t = time.perf_counter()
        self.weights = toy_weights(seed, torch.float32).to(device)
        self.phases = {"weights": time.perf_counter() - t}
        self.spans = spans
        self.size = DIM * DIM
        self.closed = False

    def step(self, x):
        t0 = time.perf_counter()
        y = (x @ self.weights).cpu()
        self.spans.add("matmul", (t0, time.perf_counter(), x.shape[0]))
        return y

    def close(self):
        self.weights = None
        self.closed = True


def toy_compare(cfg, system, answers, seed, device):
    ref = toy_weights(seed, torch.float64)
    err = max((float((y.double() - x.double() @ ref).abs().max())
               for x, y in answers.pairs), default=float("inf"))
    return {"missing": answers.missing, "max_err": err}


def toy_control_answers(c, seed, device, n_answers):
    w = toy_weights(seed, torch.bfloat16)
    x = toy_inputs(seed, n_answers)
    return None, SimpleNamespace(pairs=[(x, (x.bfloat16() @ w).float())],
                                 missing=0)


def toy_inputs(seed: int, n: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed + 1)
    return torch.randn(n, DIM, generator=g)


class ToyLoad:
    def __init__(self, system, mix, seed):
        self.system = system
        self.x = toy_inputs(seed, int(mix["rows"]))
        self.pairs = []
        self.on_open = self.on_close = lambda: None

    def warm_shapes(self):
        self.system.step(self.x)

    def run(self, seconds):
        self.on_open()
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            self.pairs.append((self.x, self.system.step(self.x)))
        self.on_close()

    @property
    def attempted(self):
        return len(self.pairs) * self.x.shape[0]

    def answers(self):
        return SimpleNamespace(pairs=self.pairs, missing=0)


@pytest.fixture
def toy(monkeypatch):
    """The toy kind and its traffic generator as modules, and a cell."""
    kind = types.ModuleType(TOY)
    kind.System, kind.compare = ToySystem, toy_compare
    kind.control_answers = toy_control_answers
    gen = types.ModuleType(TOY_MIX)
    gen.Load = ToyLoad
    monkeypatch.setitem(sys.modules, TOY, kind)
    monkeypatch.setitem(sys.modules, TOY_MIX, gen)
    return SimpleNamespace(
        name="toy.calls", chips=1,
        cfg={"name": "toy", "system": TOY.rsplit(".", 1)[1]},
        mix={"generator": TOY_MIX.rsplit(".", 1)[1], "rows": 16},
        limits={"missing": 0, "max_err": 1e-4})


def run_toy(c, metrics=()):
    return harness.run_cell(c, 2 ** 31 + 7, 0.3, False, "cpu",
                            time.perf_counter(), list(metrics))


def test_toy_kind_runs_a_cell(toy, monkeypatch):
    readers = {"setup_s": lambda run: run.setup_s,
               "toy_size": lambda run: run.size}    # the system's, via run
    monkeypatch.setattr(harness, "reader", readers.__getitem__)
    out = run_toy(toy, [{"name": "setup_s", "unit": "s"},
                        {"name": "toy_size", "unit": "values"}])
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["toy_size"]["value"] == DIM * DIM
    assert out["metrics"]["setup_s"]["value"] > 0
    assert set(out["checks"]) == {"missing", "max_err"}
    assert out["_notes"]["setup_phases_s"]["weights"] >= 0
    assert out["_notes"]["window"]["matmul_ms"] > 0


def test_toy_kind_with_an_answer_altered_is_not_correct(toy, monkeypatch):
    step = ToySystem.step

    def altered(self, x):
        y = step(self, x)
        y[0, 0] += 1e-2
        return y
    monkeypatch.setattr(ToySystem, "step", altered)
    out = run_toy(toy)
    assert not out["correct"]
    assert out["checks"]["max_err"]["value"] > 1e-3


def test_control_reaches_the_kinds_control_answers(toy):
    res = control.run(toy, 2 ** 31 + 3, "cpu", 64)
    assert set(res["numbers"]) == {"missing", "max_err"}
    assert not res["correct"], res["numbers"]


class Event:
    def __init__(self, name, device, start, duration):
        self._v = (name, device, start, duration)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


def test_a_kinds_own_layer_names_its_idle_gaps():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    w0 = 1_000_000_000
    events = [Event("portbench.window", cpu, w0, 100_000_000),
              Event("gemm", cuda, w0 + 10_000_000, 5_000_000),
              Event("gemm", cuda, w0 + 60_000_000, 5_000_000)]
    spans = spans_mod.Spans()
    spans.add("prefill", (5.000, 5.012))
    spans.add("decode", (5.030, 5.070))
    gaps = reduce(events, spans, 5.0)["idle_gaps_ns"]
    assert gaps == {"prefill": 10_000_000, "decode": 45_000_000,
                    "no call in flight": 35_000_000}


def test_spans_keep_a_list_a_layer():
    spans = spans_mod.Spans()
    spans.add("decode", (1.0, 2.0))
    spans.add("search", (3.0, 4.0, 64, 10, "certified"))
    assert spans.decode == [(1.0, 2.0)]
    assert set(spans_mod.layers(spans)) == {"encode", "search", "decode"}
    for name in ("lock", "add"):
        with pytest.raises(ValueError):
            spans.add(name, (0.0, 1.0))


# ------------------------------------------------------------ retrieval


@pytest.mark.parametrize("cell", ["minilm-l6.f32-4m.search-saturated",
                                  "mrl128.bf16-10m.batch-b4096"])
def test_retrieval_compare_is_the_checks(tiny_cell, cell):
    c = tiny_cell(cell)
    seed = 2 ** 31 + 11
    inputs, ans = retrieval.control_answers(c, seed, "cpu", 128)
    dev = torch.device("cpu")
    encoder = (retrieval.system.reference_encoder(c.cfg, dev)
               if c.cfg.get("encoder") else None)
    want = check.compare(c.cfg, inputs.corpus, ans, seed, dev, encoder)
    got = retrieval.compare(c.cfg, inputs, ans, seed, dev)
    assert got == want
    assert set(got) == set(c.limits)


@pytest.mark.parametrize("config", [c["name"] for c in B["configs"]])
def test_each_configuration_names_a_kind_with_its_parts(config):
    entry = next(c for c in B["configs"] if c["name"] == config)
    kind = harness.kind(harness.load_json(harness.ROOT, entry["file"]))
    for part in ("System", "compare", "control_answers"):
        assert callable(getattr(kind, part)), part


def test_a_configuration_without_its_kind_is_refused(tmp_path, monkeypatch,
                                                     capsys):
    cell = B["workloads"][0]
    entry = next(c for c in B["configs"] if c["name"] == cell["config"])
    cfg = harness.load_json(harness.ROOT, entry["file"])
    del cfg["system"]
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    bench = dict(B, configs=[dict(c, file=str(path)) if c is entry else c
                             for c in B["configs"]])
    with pytest.raises(harness.Refused, match='"system"'):
        harness.cell(bench, cell["name"])
    monkeypatch.setattr(harness, "benchmark", lambda: bench)
    rc = harness.main(["--workload", cell["name"], "--seed", "1",
                       "--seconds", "1"], time.perf_counter())
    assert rc == 2
    err = capsys.readouterr()
    assert '"system"' in err.err and not err.out


@pytest.mark.parametrize("name", ["harness.py", "control.py"])
def test_harness_and_control_name_no_part_of_a_kind(name):
    with open(os.path.join(harness.HERE, name), encoding="utf-8") as f:
        text = f.read()
    for word in ("corpus", "encoder", "index", "n_rows", "ids", "served",
                 "batch"):
        assert not re.search(rf"\b{word}\b", text), word


def test_loading_the_retrieval_kind_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "import portbench.systems.retrieval\n"
            "print(harness.forbidden_loaded())\n") % harness.ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
