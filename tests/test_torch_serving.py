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
"""

import glob
import os
import threading

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
from optimized_rag_tpu_torch.serving import QueryServer

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
