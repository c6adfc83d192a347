"""LexicalIndex and BM25 of the PyTorch port against the JAX package's.

Tokens, term ids and the built arrays must be identical (idf within 1e-6
relative: both take a float32 log, whose last bit may differ between
XLA's and PyTorch's). Search must give the same ids, and scores within
1e-6 relative, with the champion lists exact (cap >= df, also held
against an independent BM25 in float64) and truncated (cap < df).
"""

import glob
import os

import numpy as np
import pytest
import torch

from optimized_rag_tpu.index.lexical import LexicalIndex as JaxLexical
from optimized_rag_tpu.index.lexical import _light_stem as jax_stem
from optimized_rag_tpu.index.lexical import lexical_tokens as jax_tokens
from optimized_rag_tpu.ops import bm25 as jax_bm25
from optimized_rag_tpu_torch.index.lexical import (
    LexicalIndex, _light_stem, lexical_tokens)
from optimized_rag_tpu_torch.ops import bm25

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QA_DOCS = sorted(glob.glob(os.path.join(
    REPO, "optimized_rag_tpu", "eval", "qa_docs", "*.md")))
RTOL = 1e-6
QUERIES = ["How does the dense index handle deletes?",
           "memory tier policy and budget owners",
           "scanning scans scanned storage stored storing",
           "tpu hardware memory bandwidth bfloat16",
           "hybrid search fusion weights",
           "zzzqqq nothing matches this"]


def _chunks():
    out = []
    for path in QA_DOCS:
        with open(path, encoding="utf-8") as f:
            out += [p.strip() for p in f.read().split("\n\n") if p.strip()]
    return out


def _corpus(seed=0, n_filler=300):
    """The qa_docs chunks and seeded filler chunks of 12-40 of their own
    words (so common terms have df in the hundreds)."""
    chunks = _chunks()
    words = [w for c in chunks for w in c.split()]
    rng = np.random.default_rng(seed)
    filler = [" ".join(rng.choice(words, size=int(rng.integers(12, 41))))
              for _ in range(n_filler)]
    return chunks + filler


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


def _pair(corpus, **kw):
    ref, port = JaxLexical(**kw), LexicalIndex(**kw, device="cpu")
    ref.add(corpus)
    port.add(corpus)
    ref.build()
    port.build()
    return ref, port


def test_tokens_and_term_ids_match_jax(corpus):
    ref, port = JaxLexical(), LexicalIndex(device="cpu")
    for text in corpus + QUERIES + ["naïve café — ünïcode", ""]:
        toks = lexical_tokens(text)
        assert toks == jax_tokens(text)
        assert [port._term_id(t) for t in toks] == \
            [ref._term_id(t) for t in toks]
    for w in ("scanning", "scans", "stored", "storing", "bfloat16", "passes",
              "quickly", "runs", "tree"):
        assert _light_stem(w) == jax_stem(w)


@pytest.mark.parametrize("cap", [1024, 8])
def test_build_arrays_match_jax(corpus, cap):
    ref, port = _pair(corpus, vocab_hash_bits=14, cap=cap)
    assert port._row_of == ref._row_of
    for key in ("champ_docs", "champ_tf", "champ_valid", "doc_len",
                "avg_len"):
        np.testing.assert_array_equal(port._device[key].numpy(),
                                      np.asarray(ref._device[key]), key)
    np.testing.assert_allclose(port._device["idf"].numpy(),
                               np.asarray(ref._device["idf"]), rtol=RTOL)
    # cap 8 truncates: some term's df exceeds it.
    assert (max(len(p) for p in port._postings.values()) > cap) == (cap == 8)


def _bm25_oracle(corpus, query, term_id, k1=1.5, b=0.75):
    """Okapi BM25 in float64 over the whole corpus (rank_bm25's formula
    with this idf), each query token counted once per occurrence; terms
    are the index's hashed term ids, so colliding words are one term."""
    toks = [[term_id(w) for w in lexical_tokens(t)] for t in corpus]
    n = len(toks)
    avg = np.mean([len(t) for t in toks])
    want = np.zeros(n)
    for term in [term_id(w) for w in lexical_tokens(query)]:
        df = sum(term in t for t in toks)
        if not df:
            continue
        idf = np.log((n - df + 0.5) / (df + 0.5) + 1)
        for d, t in enumerate(toks):
            tf = t.count(term)
            if tf:
                want[d] += idf * tf * (k1 + 1) / (
                    tf + k1 * (1 - b + b * len(t) / avg))
    return want


@pytest.mark.parametrize("cap", [1024, 8])
@pytest.mark.parametrize("query", QUERIES)
def test_search_matches_jax(corpus, cap, query):
    ref, port = _pair(corpus, vocab_hash_bits=14, cap=cap)
    s_ref, i_ref = ref.search(query, k=20)
    s, i = port.search(query, k=20)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(s, s_ref, rtol=RTOL)
    if cap == 1024:   # exact champion lists: the float64 oracle's ranking
        want = _bm25_oracle(corpus, query, port._term_id)
        order = np.argsort(-want, kind="stable")
        matched = order[want[order] > 0][:20]
        m = len(matched)
        # Ids may differ from the oracle's only between float32 near-ties:
        # the oracle's scores at the port's ids are its own ranking's.
        np.testing.assert_allclose(want[i[:m]], want[matched], rtol=1e-5)
        np.testing.assert_allclose(s[:m], want[matched], rtol=1e-5)
        assert (i[m:] == -1).all() and len(set(i[:m])) == m


def test_repeated_stemmed_term_counts_twice(corpus):
    """'scan' and 'scans' stem alike: encode_query keeps both rows, and
    the score adds the term twice, in query-term order."""
    ref, port = _pair(corpus, vocab_hash_bits=14, cap=1024)
    query = "scan scans scanning"
    q, valid = port.encode_query(query)
    assert valid.sum() == 3 and len(set(q[valid])) == 1
    np.testing.assert_array_equal(q, ref.encode_query(query)[0])
    s_ref, i_ref = ref.search(query, k=10)
    s, i = port.search(query, k=10)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(s, s_ref, rtol=RTOL)
    s1, i1 = port.search("scan", k=10)
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_allclose(s, 3 * s1, rtol=RTOL)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dict_across_packages(corpus, direction):
    ref, port = _pair(corpus[:120], vocab_hash_bits=13, cap=16)
    if direction == "jax_to_port":
        a, b = ref, LexicalIndex.from_state_dict(ref.state_dict(),
                                                 device="cpu")
    else:
        a, b = port, JaxLexical.from_state_dict(port.state_dict())
    for key, val in a.state_dict().items():
        np.testing.assert_array_equal(np.asarray(b.state_dict()[key]),
                                      np.asarray(val), key)
    for query in QUERIES:
        s_a, i_a = a.search(query, 8)
        s_b, i_b = b.search(query, 8)
        np.testing.assert_array_equal(i_a, i_b)
        np.testing.assert_allclose(s_a, s_b, rtol=RTOL)


def test_bm25_idf_matches_jax():
    rng = np.random.default_rng(3)
    df = rng.integers(0, 5000, 257).astype(np.int64)
    got = bm25.bm25_idf(torch.from_numpy(df), 5000).numpy()
    want = np.asarray(jax_bm25.bm25_idf(df.astype(np.int32), 5000))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("size", [None, 200, 37])
def test_bm25_topk_size_masking_matches_jax(size):
    """Random champion arrays with duplicate query terms; documents at or
    past ``size`` score -inf."""
    rng = np.random.default_rng(5)
    v, cap, n = 16, 8, 256
    docs = np.stack([rng.permutation(n)[:cap] for _ in range(v)]).astype(
        np.int32)
    tf = rng.integers(1, 6, (v, cap)).astype(np.float32)
    cvalid = rng.random((v, cap)) < 0.8
    idf = rng.random(v).astype(np.float32) * 3
    dlen = rng.integers(5, 60, n).astype(np.float32)
    avg = np.float32(dlen.mean())
    q = np.array([3, 7, 3, 11, 0, 0], np.int32)
    qv = np.array([1, 1, 1, 1, 0, 0], bool)
    args = (q, qv, docs, tf, cvalid, idf, dlen, avg)
    s_ref, i_ref = jax_bm25.bm25_topk(*args, k=20, size=size)
    s, i = bm25.bm25_topk(*map(torch.as_tensor, args), k=20, size=size)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=RTOL)
    if size is not None:
        full = bm25.bm25_score_champions(*map(torch.as_tensor, args))
        assert torch.isinf(full[size:]).sum() == 0
        assert set(i[torch.isfinite(s)].tolist()) <= set(range(size))
