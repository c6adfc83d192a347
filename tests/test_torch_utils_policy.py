"""The port's index policy and host utilities against the JAX package's.

``select_index_kind`` is copied policy and must agree everywhere.
``build_index_for`` builds the port's ``DenseIndex`` on the device asked
for; the kinds still to port (IVF, the sharded indexes) raise naming their
ROADMAP item. The profiling, health and compile-cache helpers wrap
torch where the reference wraps JAX; language detection, token budgets,
retry, logging and the metrics exporter are copies and must give the
JAX package's outputs.
"""

import json
import logging
import os
import time

import numpy as np
import pytest
import torch

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
    ("ivf", "item 7"), ("sharded_dense", "item 8"),
    ("sharded_ivf", "item 8")])
def test_build_index_for_kinds_not_ported_raise(kind, item):
    with pytest.raises(NotImplementedError, match=item):
        policy.build_index_for(kind, 64, Settings(), mesh=object(),
                               device="cpu")
    with pytest.raises(ValueError, match="unknown index kind"):
        policy.build_index_for("hnsw", 64, Settings(), device="cpu")


@pytest.mark.parametrize("dp", [0, 1])
def test_mesh_or_none_single_device(dp):
    s = Settings()
    s.mesh.data_parallel = dp
    assert policy.mesh_or_none(s) is None


def test_mesh_or_none_several_devices_raise():
    s = Settings()
    s.mesh.data_parallel = 4
    with pytest.raises(NotImplementedError, match="item 8"):
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


def test_stage_timer_export(tmp_path):
    t = profiling.StageTimer()
    with t.span("x"):
        pass
    t.export(metrics_export.MetricsExporter(str(tmp_path)))
    (path,) = list(tmp_path.iterdir())
    rec = json.loads(path.read_text())
    assert rec["kind"] == "stage_timings" and rec["stages"]["x"]["count"] == 1


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

