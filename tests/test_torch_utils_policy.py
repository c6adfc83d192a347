"""The port's index policy and host utilities against the JAX package's.

``select_index_kind`` is copied policy and must agree everywhere.
``build_index_for`` builds the port's ``DenseIndex`` on the device asked
for (its ``IVFIndex``: ``tests/test_torch_ivf.py``) and the sharded indexes
of the JAX package's types over a mesh that ``mesh_or_none`` lays out as
the JAX package does (8 logical CPU devices here, its 8 virtual ones
there). The profiling, health and compile-cache helpers wrap
torch where the reference wraps JAX; language detection, token budgets,
retry, logging and the metrics exporter are copies and must give the
JAX package's outputs.
"""

import json
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

from optimized_rag_tpu.config import Settings as JaxSettings
from optimized_rag_tpu.index import policy as jax_policy
from optimized_rag_tpu.utils import lang as jax_lang
from optimized_rag_tpu.utils import metrics_export as jax_metrics
from optimized_rag_tpu.utils import profiling as jax_profiling
from optimized_rag_tpu.utils import retry as jax_retry
from optimized_rag_tpu.utils import tokens as jax_tokens
from optimized_rag_tpu_torch.config import Settings
from optimized_rag_tpu_torch.index import policy
from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.utils import compile_cache, health, lang
from optimized_rag_tpu_torch.utils import logging_config, metrics_export
from optimized_rag_tpu_torch.utils import profiling, retry, tokens


# ---------------------------------------------------------------- policy

@pytest.mark.parametrize("n,devices", [
    (10_000, 1), (3_999_999, 1), (4_000_000, 1), (5_000_000, 1),
    (10_000, 8), (249_999, 8), (250_000, 8), (300_000, 8), (5_000_000, 8),
    (0, 0), (262_144, 1), (16_000_000, 1), (16_000_000, 2)])
def test_select_index_kind_matches_jax(n, devices):
    for kw in ({}, {"ivf_min_size": 4_000_000, "shard_min_size": 250_000}):
        assert policy.select_index_kind(n, devices, **kw) == \
            jax_policy.select_index_kind(n, devices, **kw)


def test_build_index_for_dense_on_the_device_asked():
    idx = policy.build_index_for("dense", 64, Settings(), capacity_block=512,
                                 tile=256, device="cpu")
    assert isinstance(idx, DenseIndex)
    assert (idx.device.type, idx.dim, idx.capacity_block, idx.tile) == \
        ("cpu", 64, 512, 256)


@pytest.mark.parametrize("kind,item", [
    ("sharded_dense", "item 8"), ("sharded_ivf", "item 8")])
def test_build_index_for_builds_the_sharded_kinds(kind, item):
    """The sharded kinds, no longer raising since ROADMAP Queue 1 ``item``
    ported them, build the JAX package's index types and settings over a
    mesh of the same shape; a missing mesh and an unknown kind raise."""
    s, j_s = Settings(), JaxSettings()
    for cfg in (s, j_s):
        cfg.mesh.data_parallel = 4
    idx = policy.build_index_for(kind, 64, s, tile=256,
                                 mesh=policy.mesh_or_none(s, "cpu"))
    ref = jax_policy.build_index_for(kind, 64, j_s, tile=256,
                                     mesh=jax_policy.mesh_or_none(j_s))
    assert type(idx).__name__ == type(ref).__name__, item
    fields = (("dim", "ndev", "tile", "shard_capacity") if
              kind == "sharded_dense" else
              ("ndev", "num_clusters", "nprobe", "kmeans_iters", "tile"))
    assert [getattr(idx, f) for f in fields] == \
        [getattr(ref, f) for f in fields]
    assert {d.type for d in idx.mesh.devices.flat} == {"cpu"}
    with pytest.raises(ValueError, match="needs a mesh"):
        policy.build_index_for(kind, 64, s, device="cpu")
    with pytest.raises(ValueError, match="unknown index kind"):
        policy.build_index_for("hnsw", 64, Settings(), device="cpu")


@pytest.mark.parametrize("dp", [0, 1])
def test_mesh_or_none_single_device(dp):
    s = Settings()
    s.mesh.data_parallel = dp
    assert policy.mesh_or_none(s) is None


def test_mesh_or_none_several_devices_raise(monkeypatch):
    """Several devices give the JAX package's mesh shape (logical CPU
    devices when asked for the CPU, or the devices handed in); on CUDA
    without a card, or with too few devices, mesh_or_none raises."""
    s, j_s = Settings(), JaxSettings()
    for dp, mp in ((4, 1), (2, 2), (8, 1)):
        for cfg in (s, j_s):
            cfg.mesh.data_parallel, cfg.mesh.model_parallel = dp, mp
        mesh = policy.mesh_or_none(s, "cpu")
        assert mesh.shape == dict(jax_policy.mesh_or_none(j_s).shape)
        assert mesh.axis_names == ("data", "model")
    s.mesh.data_parallel, s.mesh.model_parallel = 4, 1
    handed = policy.mesh_or_none(s, devices=[torch.device("cpu")] * 4)
    assert handed.shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="devices"):
        policy.mesh_or_none(s, devices=[torch.device("cpu")] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        policy.mesh_or_none(s)


# ------------------------------------------------------------- profiling

class _Clock:
    """A module's ``time`` with one function pinned; the rest is real."""

    def __init__(self, name, fn):
        setattr(self, name, fn)

    def __getattr__(self, name):
        return getattr(time, name)


def test_stage_timer_matches_jax(monkeypatch):
    stats = []
    for mod in (profiling, jax_profiling):
        clock = iter(np.arange(0.0, 100.0, 0.125))
        monkeypatch.setattr(mod, "time", _Clock("perf_counter",
                                                lambda: next(clock)))
        t = mod.StageTimer()
        for _ in range(3):
            with t.span("turn"):
                with t.span("retrieve"):
                    pass
                with t.span("generate"):
                    pass
        stats.append(t.stats())
        t.reset()
        assert t.stats() == {}
    assert stats[0] == stats[1]
    assert set(stats[0]) == {"turn", "turn/retrieve", "turn/generate"}


def test_stage_timer_keeps_a_stack_per_thread(monkeypatch):
    """Two threads nest spans at once, one step at a time in turn (held in
    step by a barrier): each span's path and duration are its own
    thread's. The clock reads k*k at its k-th read."""
    reads = iter(float(k * k) for k in range(100))
    monkeypatch.setattr(profiling, "time", _Clock("perf_counter",
                                                  lambda: next(reads)))
    t = profiling.StageTimer()
    step = threading.Barrier(2, timeout=30)
    names = {"a": ("turn", "retrieve"), "b": ("ingest", "embed")}

    def run(me):
        outer, inner = t.span(names[me][0]), t.span(names[me][1])
        # Steps in turn: a opens its outer span, then b, a its inner, b,
        # then a closes its inner, b, a its outer, b.
        for act in (outer.__enter__, inner.__enter__,
                    lambda: inner.__exit__(None, None, None),
                    lambda: outer.__exit__(None, None, None)):
            for who in "ab":
                if who == me:
                    act()
                step.wait()
    threads = [threading.Thread(target=run, args=(me,)) for me in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    # Reads 0-7: a outer, b outer, a inner, b inner, then the same closing.
    assert {p: (s["count"], s["total_s"]) for p, s in t.stats().items()} \
        == {"turn": (1, 36.0 - 0.0), "ingest": (1, 49.0 - 1.0),
            "turn/retrieve": (1, 16.0 - 4.0),
            "ingest/embed": (1, 25.0 - 9.0)}


def test_stage_timer_keeps_its_last_records():
    """With a capacity the timer keeps its last spans as records (in the
    order they closed); its stats still count every span."""
    t = profiling.StageTimer(capacity=4)
    t0 = time.perf_counter()
    for j in range(5):
        with t.span("turn") as outer:
            outer.attrs["j"] = j
            with t.span("retrieve"):
                pass
    recs = t.records(t0)
    assert t.stats()["turn"]["count"] == t.stats()["turn/retrieve"][
        "count"] == 5
    assert [(r.name, r.attrs) for r in recs] == [
        ("retrieve", {}), ("turn", {"j": 3}), ("retrieve", {}),
        ("turn", {"j": 4})]
    for kid, top in (recs[:2], recs[2:]):
        assert (kid.parent, top.parent) == (top.id, None)
        assert top.start_ns <= kid.start_ns <= kid.end_ns <= top.end_ns
        assert 0 <= kid.cpu_ns and 0 <= top.cpu_ns
    assert {r.thread for r in recs} == {threading.get_native_id()}
    assert t.records(t0, t0) == [] and t.records(time.perf_counter()) == []


def test_device_trace_and_annotate_on_the_cpu(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("orag_stage"):
            x = torch.ones(64, 64)
            (x @ x).sum()
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "orag_stage" in names and "aten::mm" in names
    assert any(e.key == "orag_stage" for e in prof.key_averages())


# --------------------------------------------------------- health, cache

def test_health_probe_on_the_cpu_when_asked():
    rep = health.check_device_health(timeout_s=60, matmul_dim=32,
                                     device="cpu")
    assert rep["healthy"] is True
    assert (rep["backend"], rep["device_count"]) == ("cpu", 1)
    assert rep["latency_s"] >= 0


def test_health_default_device_without_cuda_is_unhealthy(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rep = health.check_device_health(timeout_s=60, matmul_dim=32)
    assert rep["healthy"] is False
    assert "CUDA is not available" in rep["error"]


def test_health_times_out(monkeypatch):
    import threading
    release = threading.Event()
    monkeypatch.setattr(torch, "ones", lambda *a, **k: release.wait(30))
    try:
        rep = health.check_device_health(timeout_s=0.2, matmul_dim=8,
                                         device="cpu")
    finally:
        release.set()
    assert rep["healthy"] is False and "did not respond" in rep["error"]


def test_setup_compilation_cache_has_nothing_to_enable():
    s = Settings()
    for flag in (True, False):
        s.flags.enable_compilation_cache = flag
        assert compile_cache.setup_compilation_cache(s) is False


# ------------------------------------------------------------ host copies

LANG_TEXTS = [
    "the cat and the dog are in the house",
    "você não sabe que isso é muito bom para mim",
    "los gatos son muy bonitos pero este perro",
    "le chat est sur la table avec les enfants",
    "der Hund und die Katze sind im Haus",
    "qual é o melhor modelo para busca semântica?",
    "¿cuál es el mejor modelo para la búsqueda?",
    "GPU", "", "12345 67890", "naïve café",
]


def test_detect_language_matches_jax():
    for text in LANG_TEXTS:
        for margin in (0.05, 0.2):
            assert lang.detect_language(text, margin) == \
                jax_lang.detect_language(text, margin)
        assert lang.is_non_english(text) == jax_lang.is_non_english(text)


class _WordTokenizer:
    def tokenize(self, text):
        return text.split()


@pytest.mark.parametrize("tokenizer", [None, _WordTokenizer()])
def test_token_helpers_match_jax(tokenizer):
    msgs = [{"role": "user", "content": "word " * n} for n in (5, 40, 200)]
    for text in ("", "short", "a much longer text " * 50):
        assert tokens.calculate_tokens(text, tokenizer) == \
            jax_tokens.calculate_tokens(text, tokenizer)
    assert tokens.calculate_messages_tokens(msgs, tokenizer) == \
        jax_tokens.calculate_messages_tokens(msgs, tokenizer)
    assert tokens.token_budget(4096) == jax_tokens.token_budget(4096)
    parts = {"system": "x " * 300, "context": "y " * 2000, "query": "q"}
    for alloc in (None, {"system": 0.5, "context": 0.5}):
        assert tokens.check_context_overflow(
            parts, 1024, alloc, tokenizer=tokenizer) == \
            jax_tokens.check_context_overflow(parts, 1024, alloc,
                                              tokenizer=tokenizer)
    for budget in (10, 100, 10_000):
        assert tokens.truncate_conversation(msgs, budget, tokenizer) == \
            jax_tokens.truncate_conversation(msgs, budget, tokenizer)


@pytest.mark.parametrize("fails,attempts", [(0, 3), (2, 3), (3, 3)])
def test_retry_with_backoff_matches_jax(fails, attempts):
    out = []
    for mod in (retry, jax_retry):
        sleeps, calls = [], []

        @mod.retry_with_backoff(max_attempts=attempts, base_delay=0.5,
                                max_delay=0.75, exceptions=(KeyError,),
                                sleep=sleeps.append)
        def flaky():
            calls.append(1)
            if len(calls) <= fails:
                raise KeyError("transient")
            return "done"
        try:
            result = flaky()
        except KeyError:
            result = "raised"
        out.append((result, len(calls), sleeps))
    assert out[0] == out[1]
    with pytest.raises(ValueError):             # not retried
        retry.retry_with_backoff(sleep=lambda s: None,
                                 exceptions=(KeyError,))(
            lambda: (_ for _ in ()).throw(ValueError()))()


def test_setup_logging_configures_the_ports_logger(tmp_path):
    root = logging.getLogger("optimized_rag_tpu_torch")
    saved = root.handlers[:], root.level
    root.handlers.clear()
    try:
        log_file = str(tmp_path / "port.log")
        got = logging_config.setup_logging("debug", log_file)
        assert got is root and root.level == logging.DEBUG
        assert len(root.handlers) == 2
        logging.getLogger("optimized_rag_tpu_torch.index").debug("hello")
        for h in root.handlers:
            h.flush()
        assert "optimized_rag_tpu_torch.index: hello" in open(
            log_file).read()
        assert logging_config.setup_logging() is root
        assert len(root.handlers) == 2            # idempotent
    finally:
        for h in root.handlers:
            h.close()
        root.handlers[:], root.level = saved[0], saved[1]


def test_metrics_exporter_matches_jax(tmp_path, monkeypatch):
    lines = []
    for mod in (metrics_export, jax_metrics):
        monkeypatch.setattr(mod, "time", _Clock("time", lambda: 1.7e9))
        d = tmp_path / mod.__name__
        exp = mod.MetricsExporter(str(d))
        p1 = exp.export({"kind": "turn", "ms": 1.5, "obj": object})
        p2 = exp.export({"kind": "turn", "ms": 2.5})
        assert p1 == p2 and os.path.dirname(p1) == str(d)
        lines.append((os.path.basename(p1), open(p1).read()))
    assert lines[0] == lines[1]
    assert len(lines[0][1].splitlines()) == 2

