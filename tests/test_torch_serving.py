"""The port's /search slice as a whole, on the CPU, against the JAX package.

Port: ``QueryServer`` -> ``EmbeddingService`` -> ``DenseIndex.search(
prefer_kernel=True)``, the certified packed path through the kernels'
twins. Reference: the JAX package's ``EmbeddingService`` ->
``DenseIndex.search(prefer_pallas=True)`` with its Pallas kernels in
interpret mode. Both encoders hold the same flax-initialised weights; both
indexes hold the same rows: for each of the qa_docs chunks a contiguous run
of near-duplicates at graded distances (score gaps >= 0.005 to the chunk),
in a random corpus of 256 tiles of 32 rows. The encoders' bf16 rounding
moves a score by less than 1e-3, so the top-k ids must be equal and the
scores agree to 1e-2. The int8 case serves the same rows from int8 storage
(the port's index loaded from the JAX index's snapshot, the same codes):
k=1 scans 4 candidates (certified int8-native path), k=4 scans 16 (256
tiles < 64*16: the tiled K7 search).

``EmbedBatcher`` (the coalescing front of concurrent encode calls) is held
to the JAX package's semantics: each caller gets exactly its own rows,
requests that arrive during a dispatch ride the next one, a stopped
batcher passes calls through, an encode error reaches every caller of its
dispatch, and a dead worker or a stop fails the queued callers instead of
stranding them. Every wait has a timeout and nothing is asserted on wall
time. Through the port's encoder a coalesced result equals a direct
encode of the request alone within the encoder tests' bf16 bound (cosine
at least 0.9999), with the encoder's cache off so no result is a hit.
"""

import glob
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.index.dense import DenseIndex as JaxDense
from optimized_rag_tpu.models.encoder import EmbeddingService as JaxService
from optimized_rag_tpu.models.encoder import TransformerConfig as JaxConfig
from optimized_rag_tpu.models.loader import _flatten
from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.models.convert import flax_to_torch
from optimized_rag_tpu_torch.models.encoder import (
    EmbeddingService, TransformerConfig)
from optimized_rag_tpu_torch.ops import topk as port_topk
from optimized_rag_tpu.serving import EmbedBatcher as JaxBatcher
from optimized_rag_tpu_torch.serving import EmbedBatcher, QueryServer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE, TILES, RUN, K = 32, 256, 8, 4


class _KernelRoute:
    """The index as QueryServer sees it, searching through the kernels and
    recording each batch's route."""

    def __init__(self, index):
        self.index = index
        self.routes = []

    def search(self, q, k):
        res = self.index.search(q, k, prefer_kernel=True)
        self.routes.append(res.route)
        return res


def _chunks():
    out = []
    for path in sorted(glob.glob(os.path.join(
            REPO, "optimized_rag_tpu", "eval", "qa_docs", "*.md"))):
        with open(path, encoding="utf-8") as f:
            out += [p.strip() for p in f.read().split("\n\n") if p.strip()]
    return out


def _corpus(rng, chunk_emb):
    n, d = TILE * TILES, chunk_emb.shape[1]
    rows = rng.standard_normal((n, d)).astype(np.float32)
    starts = rng.choice(n // RUN - 1, len(chunk_emb), replace=False) * RUN
    for e, s in zip(chunk_emb, starts):
        noise = rng.standard_normal((RUN, d)).astype(np.float32)
        noise /= np.linalg.norm(noise, axis=1, keepdims=True)
        rows[s:s + RUN] = e + 0.1 * np.arange(RUN)[:, None] * noise
    return rows[:n - 30]                      # a partial last tile


def _encoders():
    kw = dict(vocab_size=1024, hidden_dim=64, num_layers=2, num_heads=4,
              mlp_dim=128, max_seq_len=64, out_dim=32)
    ref_enc = JaxService(JaxConfig(**kw), seed=0, max_len=64)
    cfg = TransformerConfig(**kw)
    enc = EmbeddingService(cfg, params=flax_to_torch(_flatten(ref_enc.params),
                                                     cfg),
                           max_len=64, device="cpu")
    return ref_enc, enc


def _serve(enc, route, queries, k):
    """Answers of a QueryServer (4 clients, batches of up to 8)."""
    server = QueryServer(enc.encode, route, max_batch=8, workers=2)
    server.start()
    got = [None] * len(queries)

    def client(lo):
        futs = [(i, server.submit(queries[i], k=k))
                for i in range(lo, len(queries), 4)]
        for i, f in futs:
            got[i] = f.result(timeout=120)

    clients = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=300)
    server.stop()
    assert not any(t.is_alive() for t in clients + server._threads)
    return got, server.get_stats()


def test_query_server_slice_matches_jax(rng, monkeypatch):
    ref_enc, enc = _encoders()
    chunks = _chunks()
    rows = _corpus(rng, ref_enc.encode(chunks))
    ref_index = JaxDense(32, capacity_block=TILE * TILES, tile=TILE)
    index = DenseIndex(32, capacity_block=TILE * TILES, tile=TILE,
                       device="cpu")
    ref_index.add(rows)
    index.add(rows)
    queries = chunks[:16]
    want = ref_index.search(ref_enc.encode(queries), K, prefer_pallas=True)

    certified = []
    real = port_topk.topk_certified
    monkeypatch.setattr(port_topk, "topk_certified",
                        lambda *a, **kw: certified.append(1) or real(*a, **kw))
    got, stats = _serve(enc, _KernelRoute(index), queries, K)
    for i, (scores, ids) in enumerate(got):
        np.testing.assert_array_equal(ids, want.ids[i])
        np.testing.assert_allclose(scores, want.scores[i], rtol=0, atol=1e-2)
    assert stats["queries"] == len(queries) and stats["batches"] >= 2
    assert len(certified) == stats["batches"]  # every batch went certified


@pytest.mark.parametrize("k,routes", [(1, {"certified"}), (4, {"direct"})])
def test_query_server_int8_slice_matches_jax(rng, k, routes):
    ref_enc, enc = _encoders()
    chunks = _chunks()
    rows = _corpus(rng, ref_enc.encode(chunks))
    ref_index = JaxDense(32, capacity_block=TILE * TILES, tile=TILE,
                         dtype=jnp.int8)
    ref_index.add(rows)
    index = DenseIndex.from_state_dict(ref_index.state_dict(), device="cpu")
    queries = chunks[:16]
    want = ref_index.search(ref_enc.encode(queries), k, prefer_pallas=True)
    route = _KernelRoute(index)
    got, stats = _serve(enc, route, queries, k)
    for i, (scores, ids) in enumerate(got):
        np.testing.assert_array_equal(ids, want.ids[i])
        np.testing.assert_allclose(scores, want.scores[i], rtol=0, atol=1e-2)
    assert stats["queries"] == len(queries) and stats["batches"] >= 2
    assert set(route.routes) == routes


# ------------------------------------------------------------ EmbedBatcher

WAIT_S = 30          # every wait in these tests ends by then
MIN_COSINE = 0.9999  # tests/test_torch_encoder.py's bf16 bound


def _wait_until(cond):
    """Poll ``cond`` until true; fails after WAIT_S (never hangs)."""
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def _gated_encode(calls, started, gate):
    """An encode whose first dispatch waits on ``gate``: row i's first
    column is the number in text ``t-i``."""
    def encode(texts):
        calls.append(len(texts))
        if len(calls) == 1:
            started.set()
            assert gate.wait(WAIT_S)
        out = np.zeros((len(texts), 4), np.float32)
        for i, t in enumerate(texts):
            out[i, 0] = float(int(t.split("-")[1]))
        return out
    return encode


@pytest.mark.parametrize("cls", [EmbedBatcher, JaxBatcher])
def test_embed_batcher_coalesces_and_routes_rows(cls):
    calls, started, gate = [], threading.Event(), threading.Event()
    b = cls(_gated_encode(calls, started, gate)).start()
    results = {}

    def worker(i):
        results[i] = b.encode([f"t-{i * 10}", f"t-{i * 10 + 1}"])

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(6)]
    threads[0].start()
    assert started.wait(WAIT_S)          # request 0 is in its dispatch
    for t in threads[1:]:
        t.start()
    _wait_until(lambda: b._q.qsize() == 5)   # the rest wait behind it
    gate.set()
    for t in threads:
        t.join(timeout=WAIT_S)
    b.stop()
    assert not any(t.is_alive() for t in threads + [b._thread])
    for i in range(6):
        assert results[i].shape == (2, 4)
        assert results[i][:, 0].tolist() == [i * 10, i * 10 + 1]
    assert calls == [2, 10]              # 1 request, then 5 coalesced
    assert b.stats == {"dispatches": 2, "requests": 6, "texts": 12,
                       "max_coalesced": 5}


def test_embed_batcher_respects_max_texts():
    calls, started, gate = [], threading.Event(), threading.Event()
    b = EmbedBatcher(_gated_encode(calls, started, gate), max_texts=4).start()
    out = {}
    threads = [threading.Thread(target=lambda i=i: out.update(
        {i: b.encode([f"t-{i}", f"t-{i + 100}"])}), daemon=True)
        for i in range(5)]
    threads[0].start()
    assert started.wait(WAIT_S)
    for t in threads[1:]:
        t.start()
    _wait_until(lambda: b._q.qsize() == 4)
    gate.set()
    for t in threads:
        t.join(timeout=WAIT_S)
    b.stop()
    assert not any(t.is_alive() for t in threads)
    assert calls == [2, 4, 4]            # dispatches stop at 4 texts
    assert all(out[i][:, 0].tolist() == [i, i + 100] for i in range(5))


def test_embed_batcher_passes_through_when_stopped():
    b = EmbedBatcher(lambda ts: np.ones((len(ts), 3), np.float32))
    assert b.encode(["a", "b"]).shape == (2, 3)      # never started
    b.start()
    assert b.encode(["c"]).shape == (1, 3)
    b.stop()
    assert not b._thread.is_alive()
    assert b.encode(["d"]).shape == (1, 3)           # stopped
    assert b.stats["dispatches"] == 1


def test_embed_batcher_encode_error_reaches_every_caller():
    def bad_encode(texts):
        raise ValueError("boom")

    b = EmbedBatcher(bad_encode).start()
    for _ in range(2):
        with pytest.raises(ValueError, match="boom"):
            b.encode(["x"])
    b.stop()
    assert not b._thread.is_alive() and b.stats["dispatches"] == 2


def _queued_callers(b, n):
    """``n`` callers of ``b.encode`` in threads, and their outcomes."""
    outcomes = {}

    def call(i):
        try:
            outcomes[i] = b.encode([f"t-{i}"])
        except Exception as exc:         # the outcome under test
            outcomes[i] = exc
    threads = [threading.Thread(target=call, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    return threads, outcomes


def test_embed_batcher_stop_fails_queued_callers():
    calls, started, gate = [], threading.Event(), threading.Event()
    b = EmbedBatcher(_gated_encode(calls, started, gate)).start()
    first, out0 = _queued_callers(b, 1)
    assert started.wait(WAIT_S)
    rest, out = _queued_callers(b, 3)
    _wait_until(lambda: b._q.qsize() == 3)
    stopper = threading.Thread(target=b.stop, daemon=True)
    stopper.start()
    _wait_until(lambda: not b._running)
    gate.set()
    for t in first + rest + [stopper]:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in first + rest + [stopper, b._thread])
    assert out0[0][:, 0].tolist() == [0.0]
    assert all(isinstance(e, RuntimeError) and "stopped while the request"
               in str(e) for e in out.values()) and len(out) == 3


def test_embed_batcher_worker_death_fails_queued_callers(monkeypatch):
    die = threading.Event()
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    b = EmbedBatcher(lambda ts: np.zeros((len(ts), 2), np.float32))

    def dying_loop():
        assert die.wait(WAIT_S)
        raise KeyboardInterrupt("worker killed")

    b._loop_inner = dying_loop
    b.start()
    threads, out = _queued_callers(b, 3)
    _wait_until(lambda: b._q.qsize() == 3)
    die.set()
    for t in threads + [b._thread]:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads + [b._thread])
    assert not b._running
    assert len(out) == 3 and all(
        isinstance(e, RuntimeError) and "worker died" in str(e)
        for e in out.values())


def test_embed_batcher_through_the_encoder_matches_direct_encodes():
    kw = dict(vocab_size=1024, hidden_dim=64, num_layers=2, num_heads=4,
              mlp_dim=128, max_seq_len=64, out_dim=32)
    enc = EmbeddingService(TransformerConfig(**kw), seed=0, max_len=64,
                           cache_size=0, device="cpu")
    chunks = _chunks()
    rng = np.random.default_rng(5)
    requests = [[chunks[j] for j in rng.choice(len(chunks), int(n))]
                for n in rng.integers(1, 9, size=24)]
    b = EmbedBatcher(enc.encode, max_texts=256).start()
    got = [None] * len(requests)

    def client(c):
        for i in range(c, len(requests), 4):
            got[i] = b.encode(requests[i])

    clients = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(4)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=300)
    b.stop()
    assert not any(t.is_alive() for t in clients + [b._thread])
    for req, emb in zip(requests, got):
        direct = enc.encode(req)
        assert emb.shape == direct.shape == (len(req), 32)
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0,
                                   atol=1e-5)
        assert (np.sum(emb * direct, axis=1) >= MIN_COSINE).all()
    assert b.stats["requests"] == len(requests)
    assert b.stats["texts"] == sum(map(len, requests))
    assert enc.cache_stats()["entries"] == 0      # nothing came from a cache
