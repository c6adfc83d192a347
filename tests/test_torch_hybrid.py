"""The hybrid query of the PyTorch port against the JAX package's:
similarity, fusion, MMR, ``dual_topk`` / ``fuse_candidates``,
``encode_and_retrieve`` and every route of ``HybridRetriever``.

The same numpy inputs go to both. Ids and positions must be equal; scores
agree within 1e-6 where both sides compute the same float32 operations on
the same inputs, and channel scores within 1e-5 where an encoder forward
(a float32 config, Flax against torch: 2e-7 apart on these texts) or a
decay over float32 days comes in between. A fused score min-max
normalises its channels over the union, which divides the encoder's
difference by the union's semantic range (a few hundredths here): fused
scores after an encoder agree within 1e-4. ``time.time`` is pinned in
both packages.
"""

import glob
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.engine.retriever import HybridRetriever as JaxRetriever
from optimized_rag_tpu.index.dense import DenseIndex as JaxDense
from optimized_rag_tpu.index.lexical import LexicalIndex as JaxLexical
from optimized_rag_tpu.models.encoder import EmbeddingService as JaxService
from optimized_rag_tpu.models.encoder import TransformerConfig as JaxConfig
from optimized_rag_tpu.models.loader import _flatten
from optimized_rag_tpu.ops import fusion as j_fusion
from optimized_rag_tpu.ops import hybrid as j_hybrid
from optimized_rag_tpu.ops import mmr as j_mmr
from optimized_rag_tpu.ops import similarity as j_sim
from optimized_rag_tpu.ops.fused_query import (
    encode_and_retrieve as j_encode_and_retrieve)
from optimized_rag_tpu_torch.engine.retriever import HybridRetriever
from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.index.lexical import LexicalIndex
from optimized_rag_tpu_torch.models.convert import flax_to_torch
from optimized_rag_tpu_torch.models.encoder import (
    EmbeddingService, TransformerConfig)
from optimized_rag_tpu_torch.ops import fusion, hybrid, mmr, similarity
from optimized_rag_tpu_torch.ops.fused_query import encode_and_retrieve

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QA_DOCS = sorted(glob.glob(os.path.join(
    REPO, "optimized_rag_tpu", "eval", "qa_docs", "*.md")))
SAME_OPS = 1e-6     # the same float32 operations on the same inputs
ENCODED = 1e-5      # an encoder forward or a float32-days decay between
FUSED = 1e-4        # a fused score after an encoder forward
NOW = 1_790_000_000.0
SMALL = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4,
             mlp_dim=128, max_seq_len=64, out_dim=32)
QUERIES = ["How does the dense index handle deletes?",
           "memory tier policy and budget owners",
           "scanning storage with bfloat16 rows",
           "hybrid search fusion weights",
           "blorfquux wibblewobble"]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# ------------------------------------------------------------ similarity

def test_similarity_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((7, 16)).astype(np.float32)
    b = rng.standard_normal((5, 16)).astype(np.float32)
    a[3] = 0.0                                    # a zero row stays zero
    np.testing.assert_allclose(
        similarity.cosine_matrix(_t(a), _t(b)).numpy(),
        np.asarray(j_sim.cosine_matrix(a, b)), atol=SAME_OPS)
    np.testing.assert_allclose(
        similarity.pairwise_cosine(_t(a)).numpy(),
        np.asarray(j_sim.pairwise_cosine(a)), atol=SAME_OPS)
    np.testing.assert_allclose(
        similarity.batched_cosine(_t(a[:5]), _t(b)).numpy(),
        np.asarray(j_sim.batched_cosine(a[:5], b)), atol=SAME_OPS)


# ---------------------------------------------------------------- fusion

def test_minmax_normalize_matches_jax():
    """Valid masks, the degenerate range (0.5), one valid entry, none."""
    rng = np.random.default_rng(1)
    s = rng.standard_normal((5, 12)).astype(np.float32)
    s[1] = 0.25                                   # all equal: 0.5
    valid = rng.random((5, 12)) < 0.7
    valid[2] = False
    valid[2, 4] = True                            # one valid entry: 0.5
    valid[3] = False                              # none valid: 0
    for v in (valid, None):
        got = fusion.minmax_normalize(_t(s), None if v is None else _t(v))
        want = j_fusion.minmax_normalize(s, v)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SAME_OPS)
    got = fusion.minmax_normalize(_t(s), _t(valid)).numpy()
    assert (got[1][valid[1]] == 0.5).all() and got[2, 4] == 0.5
    assert (got[3] == 0).all()


def test_weighted_fusion_matches_jax():
    rng = np.random.default_rng(2)
    stack = rng.standard_normal((3, 20)).astype(np.float32)
    w = np.asarray([2.0, 1.0, 1.0], np.float32)   # renormalised to 1
    valid = rng.random(20) < 0.8
    for v in (valid, None):
        got = fusion.weighted_fusion(_t(stack), _t(w),
                                     None if v is None else _t(v))
        want = j_fusion.weighted_fusion(stack, w, v)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SAME_OPS)


def test_rrf_fuse_matches_jax():
    """Three lists over 40 ids, overlapping across lists, padded."""
    rng = np.random.default_rng(3)
    lists = np.stack([rng.permutation(40)[:10] for _ in range(3)]).astype(
        np.int32)
    valid = np.ones((3, 10), bool)
    valid[2, 7:] = False
    s, i = fusion.rrf_fuse(_t(lists), _t(valid), 15, num_candidates=40)
    s_ref, i_ref = j_fusion.rrf_fuse(lists, valid, 15, num_candidates=40)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=SAME_OPS)


def test_decay_and_blend_match_jax():
    rng = np.random.default_rng(4)
    ages = (rng.random(64) * 400).astype(np.float32)
    np.testing.assert_allclose(
        fusion.temporal_decay(_t(ages), 30.0).numpy(),
        np.asarray(j_fusion.temporal_decay(ages, 30.0)), rtol=SAME_OPS)
    new, orig = rng.random(9).astype(np.float32), rng.random(9).astype(
        np.float32)
    np.testing.assert_allclose(
        fusion.blend_rerank(_t(new), _t(orig), 0.3).numpy(),
        np.asarray(j_fusion.blend_rerank(new, orig, 0.3)), atol=SAME_OPS)


# ------------------------------------------------------------------- MMR

@pytest.mark.parametrize("lam,k", [(0.7, 6), (0.3, 6), (0.5, 14)])
def test_mmr_select_matches_jax(lam, k):
    """Padded candidates masked; k past the valid count pads with -1."""
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((16, 8)).astype(np.float32)
    emb[5] = emb[2]                               # a duplicate
    rel = rng.random(16).astype(np.float32)
    valid = np.arange(16) < 12
    o, s = mmr.mmr_select(_t(emb), _t(rel), k, lam=lam, valid=_t(valid))
    o_ref, s_ref = j_mmr.mmr_select(emb, rel, k, lam=lam, valid=valid)
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=SAME_OPS)
    assert (o.numpy()[12:] == -1).all()


# ------------------------------------------- dual_topk / fuse_candidates

def _champions(rng, n, v=24, cap=16):
    docs = np.stack([rng.permutation(n)[:cap] for _ in range(v)]).astype(
        np.int32)
    tf = rng.integers(1, 6, (v, cap)).astype(np.float32)
    cvalid = rng.random((v, cap)) < 0.8
    idf = (rng.random(v) * 3).astype(np.float32)
    dlen = rng.integers(5, 60, n).astype(np.float32)
    return docs, tf, cvalid, idf, dlen, np.float32(dlen.mean())


def _corpus(rng, dtype, n=512, d=32):
    """(jax corpus, torch corpus, row_scale numpy or None)."""
    x = _unit(rng, n, d)
    if dtype == "int8":
        codes = rng.integers(-127, 128, (n, d)).astype(np.int8)
        scale = (rng.random(n) * 0.01 + 0.001).astype(np.float32)
        return codes, _t(codes), scale
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16), None
    return x, _t(x), None


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_dual_topk_matches_jax(dtype):
    rng = np.random.default_rng(6)
    c_j, c_t, scale = _corpus(rng, dtype)
    q = _unit(rng, 2, 32)
    champ = _champions(rng, 512)
    qt = np.array([3, 7, 3, 11, 0, 0, 0, 0], np.int32)
    qv = np.array([1, 1, 1, 1, 0, 0, 0, 0], bool)
    got = hybrid.dual_topk(_t(q), c_t, 500, _t(qt), _t(qv),
                           *map(_t, champ), k=20,
                           row_scale=None if scale is None else _t(scale))
    want = np.asarray(j_hybrid.dual_topk(q, c_j, 500, qt, qv, *champ, k=20,
                                         row_scale=scale))
    got = got.numpy()
    np.testing.assert_array_equal(got[1], want[1])            # ids
    np.testing.assert_allclose(got[0], want[0], atol=SAME_OPS)
    assert (got[1] < 500).all()                               # size masked


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("all_invalid", [False, True])
def test_fuse_candidates_matches_jax(dtype, all_invalid):
    rng = np.random.default_rng(7)
    c_j, c_t, scale = _corpus(rng, dtype)
    q = _unit(rng, 1, 32)[0]
    cand = np.full(16, -1, np.int32)
    cand[:11] = np.sort(rng.permutation(512)[:11])
    valid = cand >= 0
    if all_invalid:
        valid[:] = False
    kw = np.where(rng.random(16) < 0.5, rng.random(16) * 8, 0).astype(
        np.float32)
    ages = (rng.random(16) * 300).astype(np.float32)
    w = np.asarray([0.55, 0.35, 0.10], np.float32)
    got = hybrid.fuse_candidates(q, c_t, cand, valid, kw, ages, w, 30.0,
                                 k=8, row_scale=None if scale is None
                                 else _t(scale)).numpy()
    want = np.asarray(j_hybrid.fuse_candidates(q, c_j, cand, valid, kw, ages,
                                               w, 30.0, k=8,
                                               row_scale=scale))
    np.testing.assert_array_equal(got[1], want[1])            # positions
    np.testing.assert_allclose(got, want, atol=SAME_OPS)
    assert (got[1] == -1).all() == all_invalid


# ------------------------------------------------------- the encoder path

def _texts(n_filler=200, seed=0):
    chunks = []
    for path in QA_DOCS:
        with open(path, encoding="utf-8") as f:
            chunks += [p.strip() for p in f.read().split("\n\n")
                       if p.strip()]
    words = [w for c in chunks for w in c.split()]
    rng = np.random.default_rng(seed)
    return chunks + [" ".join(rng.choice(words, size=int(rng.integers(
        12, 41)))) for _ in range(n_filler)]


@pytest.fixture(scope="module")
def texts():
    return _texts()


def _services(matryoshka=None):
    """A float32 BiEncoder in both packages from the same Flax params."""
    ref = JaxService(JaxConfig(**SMALL, dtype=jnp.float32), seed=3,
                     max_len=32, matryoshka_dim=matryoshka)
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    port = EmbeddingService(cfg, params=flax_to_torch(_flatten(ref.params),
                                                      cfg),
                            max_len=32, matryoshka_dim=matryoshka,
                            device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def services():
    return _services()


@pytest.mark.parametrize("case", ["temporal", "no_temporal", "matryoshka",
                                  "beyond_hits"])
def test_encode_and_retrieve_matches_jax(texts, case):
    matryoshka = 16 if case == "matryoshka" else None
    ref, port = _services(matryoshka)
    emb = ref.encode(texts)                       # the same rows for both
    n, d = emb.shape
    cap = 512
    corpus = np.zeros((cap, d), np.float32)
    corpus[:n] = emb
    lex_j, lex_p = JaxLexical(vocab_hash_bits=14, cap=64), LexicalIndex(
        vocab_hash_bits=14, cap=64, device="cpu")
    for lex in (lex_j, lex_p):
        lex.add(texts)
        lex.build()
    rng = np.random.default_rng(8)
    created = np.zeros(cap, np.float32)
    created[:n] = (NOW - rng.random(n) * 365 * 86400) / 86400.0
    w = np.asarray([0.55, 0.35, 0.10], np.float32)
    if case == "no_temporal":
        created[:] = 0.0
        w[2] = 0.0
    ck, k = (4, 8) if case == "beyond_hits" else (12, 6)
    for query in QUERIES:
        ids, mask = ref.tokenizer.encode_batch([query], ref.max_len)
        lj, lp = lex_j._device, lex_p._device
        qt, qv = lex_p.encode_query(query)
        want = np.asarray(j_encode_and_retrieve(
            ref.params, ids, mask, corpus, n, qt, qv, lj["champ_docs"],
            lj["champ_tf"], lj["champ_valid"], lj["idf"], lj["doc_len"],
            lj["avg_len"], created, NOW / 86400.0, w, 30.0,
            encode_fn=ref._fwd, matryoshka_dim=matryoshka, candidate_k=ck,
            k=k))
        got = encode_and_retrieve(
            port.model, ids, mask, _t(corpus), n, _t(qt), _t(qv),
            lp["champ_docs"], lp["champ_tf"], lp["champ_valid"], lp["idf"],
            lp["doc_len"], lp["avg_len"], _t(created), NOW / 86400.0, w,
            30.0, matryoshka_dim=matryoshka, candidate_k=ck, k=k).numpy()
        assert got.shape == want.shape == (6, max(k, d))
        np.testing.assert_array_equal(got[1], want[1], query)   # ids
        np.testing.assert_allclose(got[0], want[0], atol=FUSED)
        np.testing.assert_allclose(got[2:], want[2:], atol=ENCODED)
        if case == "beyond_hits" and query == QUERIES[-1]:
            # No BM25 term: a union of ck dense rows, padded with -1 to k.
            assert not qv.any()
            assert (got[1, :k] == -1).sum() == k - ck
        if matryoshka:
            np.testing.assert_allclose(np.linalg.norm(got[5, :16]), 1.0,
                                       atol=1e-6)


# -------------------------------------------------------- HybridRetriever

class FrozenANN:
    """An ANN over a snapshot of the built segment (exact, numpy)."""

    def __init__(self, emb, size):
        self.emb = np.asarray(emb, np.float32)[:size]

    def search(self, q, k):
        s = np.atleast_2d(q) @ self.emb.T
        ids = np.argsort(-s, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(s, ids, axis=1), ids.astype(np.int64)


def _retrievers(texts, services, encoder):
    """(jax retriever, port retriever) over the same rows, texts and
    timestamps; ``encoder`` turns on the one-call route."""
    ref, port = services
    emb = ref.encode(texts)
    rng = np.random.default_rng(9)
    created = {i: NOW - float(a) for i, a in enumerate(
        rng.random(len(texts) + 64) * 365 * 86400)}
    out = []
    for svc, dense, lex, cls in (
            (ref, JaxDense(emb.shape[1], capacity_block=256, tile=256),
             JaxLexical(vocab_hash_bits=14, cap=64), JaxRetriever),
            (port, DenseIndex(emb.shape[1], capacity_block=256, tile=256,
                              device="cpu"),
             LexicalIndex(vocab_hash_bits=14, cap=64, device="cpu"),
             HybridRetriever)):
        dense.add(emb)
        lex.add(texts)
        out.append(cls(dense, lex, svc.encode,
                       get_text=lambda i: f"doc {i}",
                       get_created_at=created.__getitem__, candidate_k=12,
                       encoder=svc if encoder else None))
    return out


def _same_docs(a, b, what):
    assert [d.doc_id for d in a] == [d.doc_id for d in b], what
    for key, tol in (("score", FUSED), ("semantic_score", ENCODED),
                     ("keyword_score", ENCODED), ("temporal_score", ENCODED)):
        np.testing.assert_allclose([getattr(d, key) for d in a],
                                   [getattr(d, key) for d in b],
                                   atol=tol, err_msg=f"{what} {key}")


@pytest.fixture
def pinned_time(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


@pytest.mark.parametrize("route", ["one_call", "two_call"])
def test_retriever_hybrid_routes_match_jax(texts, services, pinned_time,
                                           route):
    r_j, r_p = _retrievers(texts, services, encoder=route == "one_call")
    for query in QUERIES:
        for intent in ("question_answering", "search", None):
            _same_docs(r_j.retrieve(query, 5, intent),
                       r_p.retrieve(query, 5, intent),
                       f"{route} {query} {intent}")
    if route == "one_call":   # the query vector rode back into the cache
        q = QUERIES[0]
        assert r_p.encoder._cache[q].shape == (r_p.encoder.dim,)
        np.testing.assert_allclose(r_p.encoder._cache[q],
                                   r_j.encoder._cache[q], atol=ENCODED)


@pytest.mark.parametrize("k", [2, 10])
def test_retriever_dense_only_matches_jax(texts, services, pinned_time, k):
    r_j, r_p = _retrievers(texts, services, encoder=True)
    for query in QUERIES:
        for intent in ("conversational", "summarization"):
            got = r_p.retrieve(query, k, intent)
            _same_docs(r_j.retrieve(query, k, intent), got, query)
            assert len(got) == k and all(d.keyword_score == 0 for d in got)


def test_retriever_tombstone_route_matches_jax(texts, services, pinned_time):
    """Deletes send the hybrid query to separate calls; compacting
    rebuilds the timestamps (a new epoch) and reopens the one-call
    route."""
    r_j, r_p = _retrievers(texts, services, encoder=True)
    for r in (r_j, r_p):
        r.retrieve(QUERIES[0], 5, "question_answering")   # fills the cache
        r.dense.delete([3, 17, 40, 41])
    for query in QUERIES:
        got = r_p.retrieve(query, 5, "question_answering")
        _same_docs(r_j.retrieve(query, 5, "question_answering"), got, query)
        assert not {3, 17, 40, 41} & {d.doc_id for d in got}
    for r in (r_j, r_p):
        r.dense.compact()
    np.testing.assert_array_equal(r_p._created_days().numpy(),
                                  np.asarray(r_j._created_days()))
    for query in QUERIES:
        _same_docs(r_j.retrieve(query, 5, "fact_checking"),
                   r_p.retrieve(query, 5, "fact_checking"), query)


def test_retriever_ann_overlay_matches_jax(texts, services, pinned_time):
    """A fake ANN over the built segment, a fresh tail, and a tombstone
    the ANN still holds."""
    r_j, r_p = _retrievers(texts, services, encoder=True)
    extra = services[0].encode([f"{t} (revised)" for t in texts[:40]])
    for r in (r_j, r_p):
        r.ann = FrozenANN(np.asarray(r.dense.embeddings()), r.dense.size)
        r.ann_size = r.dense.size
        r.dense.add(extra)
        r.lexical.add([f"{t} (revised)" for t in texts[:40]])
        r.dense.delete([5])
    for query in QUERIES:
        for intent in ("question_answering", "conversational"):
            got = r_p.retrieve(query, 6, intent)
            _same_docs(r_j.retrieve(query, 6, intent), got, query)
            assert 5 not in {d.doc_id for d in got}
