"""The program's own spans (``utils.profiling.span``) on the CPU.

They record only inside a torch profiler session, read from the flag torch
keeps (``torch.autograd.profiler._is_profiler_enabled``), which is pinned
here; outside one, ``span`` reads no clock and nothing is recorded. A
``QueryServer`` over an ``EmbeddingService`` with random weights and a
small bfloat16 ``DenseIndex`` with tombstones, whose certificate is forced
to a nonzero count (the whole search's exact rerun keeps every answer
exact), records every span of the served path; each child lies inside its
parent on its parent's thread, and a batch's spans share its id. Answers are the same
with recording on and off. A ``device_trace`` file holds the spans on the
trace's own clock, each around its own ``aten::mm``.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import profile

from optimized_rag_tpu_torch.index import dense
from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.models.encoder import (
    EmbeddingService, TransformerConfig)
from optimized_rag_tpu_torch.ops.topk import Cover
from optimized_rag_tpu_torch.serving import QueryServer
from optimized_rag_tpu_torch.utils import profiling

torch.set_num_threads(2)

SERVED = {"serve.collect", "serve.handoff", "serve.dispatch", "serve.settle",
          "encode", "encode.cache", "encode.tokenize", "encode.upload",
          "encode.forward", "encode.fetch", "encode.store", "search",
          "search.prepare", "search.scan", "search.wait", "search.fallback",
          "search.rescore", "search.filter"}
WORDS = ("dense retrieval certified top-k tiles encoder batch queue host "
         "device stream kernel rescore fallback").split()


def _certificate(monkeypatch, uncovered: int) -> None:
    """``DenseIndex``'s deferred search returns the exact top-k with a
    certificate row that reads ``uncovered``, and covers that leave every
    (query, tile) pair open, so the whole search reruns."""
    real = dense.dispatch_topk

    def fake(q, corpus, k, size=None, *, tile=1024, row_scale=None, **_):
        s, i = real(q, corpus, k, size, tile=tile, row_scale=row_scale)
        row = torch.zeros((1, k), dtype=i.dtype)
        row[0, 0] = uncovered
        need = torch.ones((q.shape[0], corpus.shape[0] // tile),
                          dtype=torch.bool)
        return s, torch.cat([i, row]), Cover(need, "dense")
    monkeypatch.setattr(dense, "dispatch_deferred", fake)


def _texts(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(2, 9))))
            + f" {i}" for i in range(n)]


@pytest.fixture
def served(monkeypatch):
    _certificate(monkeypatch, 3)
    enc = EmbeddingService(TransformerConfig(
        vocab_size=512, hidden_dim=32, num_layers=1, num_heads=2, mlp_dim=64,
        max_seq_len=32, out_dim=16), seed=0, cache_size=0, max_len=32,
        device="cpu")
    index = DenseIndex(16, 256, "bfloat16", tile=64, device="cpu")
    index.add(np.random.default_rng(1).standard_normal((500, 16)))
    index.delete([3, 40, 77])
    server = QueryServer(enc.encode, index, max_batch=8, max_wait_ms=2,
                         max_k=16, workers=2)
    server.start()
    yield server
    server.stop()
    assert not any(t.is_alive() for t in server._threads)


def _drive(server, texts, clients=4):
    """``texts`` sent by ``clients`` threads at once; the answers by text."""
    out = {}

    def client(c):
        for t in texts[c::clients]:
            out[t] = server.search(t, k=4, timeout=60)
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(out) == len(texts)
    return out


def test_the_profiler_flag_is_pinned():
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False and profiling.span("x") is profiling.OFF
    with profile():
        assert flag() is True
        assert isinstance(profiling.span("x"), profiling.Span)
        assert isinstance(profiling.detached("x"), profiling.Span)
    assert flag() is False and profiling.detached("x") is profiling.OFF


def test_off_spans_read_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while off")

    class Clock:
        perf_counter = perf_counter_ns = thread_time_ns = staticmethod(
            no_clock)
    monkeypatch.setattr(profiling, "time", Clock)
    with profiling.span("a") as sp:
        assert not sp
    h = profiling.detached("b")
    h.finish()
    assert not h


def test_nothing_is_recorded_without_a_profiler(served):
    t0 = time.perf_counter()
    _drive(served, _texts(12, 2))
    assert profiling.RECORDER.records(t0, time.perf_counter()) == []


def test_served_batches_record_every_span(served):
    t0 = time.perf_counter()
    with profile():
        _drive(served, _texts(24, 3))
    recs = profiling.RECORDER.records(t0, time.perf_counter())
    assert {r.name for r in recs} == SERVED
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.end_ns >= r.start_ns
        if r.parent is None:
            assert r.name.startswith("serve.") and r.name != "serve.settle"
            continue
        p = by_id[r.parent]
        assert p.thread == r.thread
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
        assert r.cpu_ns is not None
        if "." in r.name and not r.name.startswith("serve."):
            assert p.name == r.name.split(".")[0]
        else:
            assert p.name == "serve.dispatch"

    def ids(name):
        return sorted(r.attrs["batch"] for r in recs if r.name == name)
    dispatched = ids("serve.dispatch")
    assert len(set(dispatched)) == len(dispatched) >= 3
    assert ids("serve.collect") == ids("serve.handoff") == dispatched
    n = {r.attrs["batch"]: r.attrs["n"] for r in recs
         if r.name == "serve.collect"}
    d = [r for r in recs if r.name == "serve.dispatch"]
    assert sum(r.attrs["n"] for r in d) == 24
    for r in d:
        assert r.attrs["n"] == n[r.attrs["batch"]]
        assert r.attrs["bucket"] >= r.attrs["n"] and r.attrs["k_eff"] == 4
        assert 0 <= r.attrs["wait_ms_max"] <= r.attrs["wait_ms_sum"]
    for r in recs:
        if r.name == "search":
            assert r.attrs == {"B": by_id[r.parent].attrs["bucket"], "k": 4,
                               "cc": 28, "route": "fallback",
                               "uncovered": 3}
        elif r.name == "encode":
            batch = by_id[r.parent].attrs
            assert r.attrs == {"texts": batch["bucket"], "misses": batch["n"],
                               "bucket": max(8, batch["n"])}


def test_answers_are_the_same_with_recording_on_and_off(served):
    texts = _texts(10, 4)
    off = {t: served.search(t, k=4, timeout=60) for t in texts}
    with profile():
        on = {t: served.search(t, k=4, timeout=60) for t in texts}
    for t in texts:
        np.testing.assert_array_equal(on[t][1], off[t][1])
        np.testing.assert_array_equal(on[t][0], off[t][0])


@pytest.mark.parametrize("uncovered,route", [(0, "certified"),
                                             (3, "fallback")])
def test_search_records_route_and_uncovered_of_a_certificate_row(
        monkeypatch, uncovered, route):
    rng = np.random.default_rng(6)
    index = DenseIndex(16, 256, tile=64, device="cpu")
    index.add(rng.standard_normal((300, 16)))
    q = rng.standard_normal((5, 16))
    want = index.search(q, 4)
    _certificate(monkeypatch, uncovered)
    t0 = time.perf_counter()
    with profile():
        got = index.search(q, 4)
    recs = profiling.RECORDER.records(t0, time.perf_counter())
    (top,) = [r for r in recs if r.name == "search"]
    assert top.attrs == {"B": 5, "k": 4, "cc": 4, "route": route,
                         "uncovered": uncovered}
    assert ("search.fallback" in {r.name for r in recs}) == bool(uncovered)
    assert (want.route, got.route) == ("direct", route)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-6)


def test_device_trace_holds_the_spans_around_their_own_ops(tmp_path):
    """The profiler records the operators of the thread that started it;
    a span of another thread lands on that thread's row."""
    x = torch.ones(128, 128)
    tids = {}

    def work(tag, op):
        tids[tag] = threading.get_native_id()
        for j in range(3):
            with profiling.span(f"{tag}{j}"):
                time.sleep(0.002)
                op()
                time.sleep(0.002)
            time.sleep(0.01)
    with profiling.device_trace(str(tmp_path)):
        other = threading.Thread(target=work, args=("side", lambda: None))
        other.start()
        work("main", lambda: x @ x)
        other.join(timeout=30)
    assert not other.is_alive()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "orag_span"]
    mms = [e for e in events if e.get("name") == "aten::mm"]
    assert sorted(e["name"] for e in spans) == sorted(
        f"{t}{j}" for t in ("main", "side") for j in range(3))
    assert len(mms) == 3
    for s in spans:
        assert s["tid"] == tids[s["name"][:4]]
        if s["name"].startswith("main"):
            mine = [m for m in mms if s["ts"] - 1000 <= m["ts"]
                    and m["ts"] + m["dur"] <= s["ts"] + s["dur"] + 1000]
            assert len(mine) == 1 and mine[0]["tid"] == s["tid"], s
