"""Post-retrieval scoring of the PyTorch port against the JAX package's:
the cross-encoder, its service, the SelectiveReranker's routing and stats,
``rerank_eval_fused`` in its three modes, and ``FusedRerankEval.run``
(against the JAX package's and against the port's own modular path).

Small models are float32 configs converted from the same Flax params, so
the two packages' logits and embeddings agree within 1e-5 and every
selection must be equal. The pretrained cross-encoder (logits up to about
9.3 in magnitude on the qa_docs pairs) run in float32 in both packages
agrees within 1e-4 (measured 7.6e-6): the conversion is exact. Run as
shipped, its trunk computes in bfloat16 in both packages, which round at
different places, and the [CLS] row is not averaged over tokens as the
BiEncoder's pooling is: logits agree within PRETRAINED_LOGIT_ATOL
(measured worst 0.247 over the three queries' pairs) and sigmoid scores
within PRETRAINED_SCORE_ATOL (measured 0.035).
"""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.engine.fused import FusedRerankEval as JaxFused
from optimized_rag_tpu.engine.rerank import SelectiveReranker as JaxReranker
from optimized_rag_tpu.engine.types import RetrievedDoc as JaxDoc
from optimized_rag_tpu.models.encoder import (
    CrossEncoderService as JaxCrossService)
from optimized_rag_tpu.models.encoder import EmbeddingService as JaxService
from optimized_rag_tpu.models.encoder import TransformerConfig as JaxConfig
from optimized_rag_tpu.models.loader import _flatten
from optimized_rag_tpu.models.pretrain import load_pretrained
from optimized_rag_tpu.models.pretrain import load_tokenizer as jax_tokenizer
from optimized_rag_tpu.ops.fused_eval import (
    rerank_eval_fused as j_rerank_eval_fused)
from optimized_rag_tpu_torch.config import RerankConfig, Settings
from optimized_rag_tpu_torch.engine.fused import FusedRerankEval
from optimized_rag_tpu_torch.engine.rerank import SelectiveReranker
from optimized_rag_tpu_torch.engine.types import Intent, RetrievedDoc
from optimized_rag_tpu_torch.models.convert import (
    flax_to_torch, load_crossencoder)
from optimized_rag_tpu_torch.models.encoder import (
    CrossEncoderService, EmbeddingService, TransformerConfig)
from optimized_rag_tpu_torch.ops.fused_eval import rerank_eval_fused
from optimized_rag_tpu_torch.ops.similarity import cosine_matrix

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "pretrained")
QA_DOCS = sorted(glob.glob(os.path.join(
    REPO, "optimized_rag_tpu", "eval", "qa_docs", "*.md")))
TOL = 1e-5                     # float32 configs, Flax against torch
PRETRAINED_F32_ATOL = 1e-4     # full width in float32: measured 7.6e-6
PRETRAINED_LOGIT_ATOL = 0.35   # bf16 trunk: measured worst 0.247
PRETRAINED_SCORE_ATOL = 0.05   # the same after the sigmoid: 0.035
SMALL = dict(vocab_size=1024, hidden_dim=64, num_layers=2, num_heads=4,
             mlp_dim=128, out_dim=32, max_seq_len=64)
TEXTS = [
    "tpus accelerate matrix multiplication with systolic arrays",
    "postgres stores rows in relational tables",
    "bananas grow in tropical climates",
    "systolic arrays pump data through multiply units",
    "embedding vectors live in high dimensional space",
    "the quick brown fox jumps over the lazy dog",
    "matrix multiplication dominates transformer flops",
    "dogs and foxes are both canids",
    "retrieval quality depends on reranking depth",
    "compression trades context tokens for latency",
    "bfloat16 halves the bytes each row of the index takes",
    "the certificate proves the answer exact or reruns the scan",
]
QUERIES = ["matrix multiplication hardware", "tell me about foxes and dogs",
           "how does the index store rows"]


def _chunks():
    out = []
    for path in QA_DOCS:
        with open(path, encoding="utf-8") as f:
            out += [p.strip() for p in f.read().split("\n\n") if p.strip()]
    return out


def _services():
    """(jax embed, jax cross, port embed, port cross): float32 configs,
    the port's weights converted from the JAX services' Flax params."""
    jcfg = JaxConfig(**SMALL, dtype=jnp.float32)
    svc_j = JaxService(jcfg, seed=3, max_len=32)
    ce_j = JaxCrossService(jcfg, seed=7, max_len=64)
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    svc_p = EmbeddingService(cfg, params=flax_to_torch(
        _flatten(svc_j.params), cfg), max_len=32, device="cpu")
    ce_p = CrossEncoderService(cfg, params=flax_to_torch(
        _flatten(ce_j.params), cfg), max_len=64, device="cpu")
    return svc_j, ce_j, svc_p, ce_p


@pytest.fixture(scope="module")
def services():
    return _services()


def _docs(n, scores=None, cls=RetrievedDoc):
    scores = scores or [0.9 - 0.07 * i for i in range(n)]
    return [cls(doc_id=i, score=float(scores[i]), text=TEXTS[i])
            for i in range(n)]


# --------------------------------------------------------- cross-encoder

def test_small_cross_encoder_matches_jax(services):
    """A Flax-initialised 2-layer cross-encoder converted to torch: the
    same logits on token pairs with type ids."""
    _, ce_j, _, ce_p = services
    pairs = [(q, t) for q in QUERIES for t in TEXTS]
    ids, mask, types = ce_p.tokenizer.encode_pairs(pairs, 64)
    assert types.any() and (types <= mask).all()
    want = np.asarray(ce_j._fwd(ce_j.params, ids, mask, types))
    got = ce_p.logits(ids, mask, types).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("n", [1, 9, 40])
def test_score_pairs_matches_jax(services, n):
    """Bucket padding (8, 32, 64) and the float32 sigmoid."""
    _, ce_j, _, ce_p = services
    docs = (TEXTS * 4)[:n]
    got = ce_p.score_pairs(QUERIES[0], docs)
    want = ce_j.score_pairs(QUERIES[0], docs)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert ce_p.score_pairs("q", []).shape == (0,)


def _pretrained_pair(dtype):
    """(jax service, port service) of the in-repo checkpoint, configured
    as the agent configures it, the trunk in ``dtype`` (None: as shipped,
    bfloat16)."""
    from optimized_rag_tpu_torch.models.convert import (
        load_config, load_params, load_tokenizer)
    cfg, params = load_pretrained(CKPT, "crossencoder")
    max_len = min(cfg.max_seq_len, 256)
    if dtype is None:
        port = load_crossencoder(CKPT, device="cpu")
    else:
        cfg = dataclasses.replace(cfg, dtype=jnp.float32)
        pcfg = dataclasses.replace(load_config(CKPT, "crossencoder"),
                                   dtype=torch.float32)
        port = CrossEncoderService(
            pcfg, params=flax_to_torch(load_params(CKPT, "crossencoder"),
                                       pcfg), max_len=max_len,
            tokenizer=load_tokenizer(CKPT, pcfg.vocab_size, max_len),
            device="cpu")
    ref = JaxCrossService(cfg, params=params, max_len=max_len,
                          tokenizer=jax_tokenizer(CKPT, cfg.vocab_size,
                                                  max_len))
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", None])
def test_pretrained_cross_encoder_matches_jax(dtype):
    """The in-repo checkpoint at full width on (query, chunk) pairs of the
    qa_docs: exact conversion in float32, bf16 rounding as shipped."""
    ref, port = _pretrained_pair(dtype)
    assert (port.cfg.num_layers, port.cfg.hidden_dim, port.cfg.num_heads,
            port.cfg.mlp_dim, port.max_len) == (6, 384, 12, 1536, 128)
    chunks = _chunks()
    pairs = [(q, c) for q in QUERIES for c in chunks]
    ids, mask, types = port.tokenizer.encode_pairs(pairs, port.max_len)
    np.testing.assert_array_equal(
        ids, ref.tokenizer.encode_pairs(pairs, ref.max_len)[0])
    got = np.concatenate([port.logits(ids[i:i + 32], mask[i:i + 32],
                                      types[i:i + 32]).numpy()
                          for i in range(0, len(pairs), 32)])
    want = np.concatenate([np.asarray(ref._fwd(
        ref.params, ids[i:i + 32], mask[i:i + 32], types[i:i + 32]))
        for i in range(0, len(pairs), 32)])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=PRETRAINED_F32_ATOL
                               if dtype else PRETRAINED_LOGIT_ATOL)
    if dtype is None:
        np.testing.assert_allclose(
            port.score_pairs(QUERIES[2], chunks[:20]),
            ref.score_pairs(QUERIES[2], chunks[:20]),
            atol=PRETRAINED_SCORE_ATOL)


# ----------------------------------------------------- SelectiveReranker

ROUTING_CASES = [
    (5, Intent.QUESTION_ANSWERING, None),                 # precision: ce
    (10, Intent.CONVERSATIONAL, [0.5] * 10),              # low var: emb
    (4, Intent.CONVERSATIONAL, [0.9, 0.8, 0.7, 0.6]),     # few: skip
    (4, Intent.CONVERSATIONAL, [0.04, 0.03, 0.02, 0.01]),  # low: force
    (10, Intent.CLARIFICATION,
     [0.95, 0.1, 0.08, 0.07, 0.06, 0.05, 0.04, 0.03, 0.02, 0.01]),
    (10, Intent.INSTRUCTION, [0.5 + 0.03 * i for i in range(10)]),
    (8, "not an intent", [0.5] * 8),                      # default route
]


@pytest.mark.parametrize("with_ce", [True, False])
def test_selective_reranker_matches_jax(services, with_ce):
    """Routing, reasons, stats and the reranked docs, every case."""
    svc_j, ce_j, svc_p, ce_p = services
    rr_j = JaxReranker(cross_encoder=ce_j if with_ce else None,
                       embed_fn=svc_j.encode)
    rr_p = SelectiveReranker(cross_encoder=ce_p if with_ce else None,
                             embed_fn=svc_p.encode, device="cpu")
    for n, intent, scores in ROUTING_CASES:
        d_j, d_p = _docs(n, scores, JaxDoc), _docs(n, scores)
        assert rr_p.should_rerank(d_p, intent) == \
            rr_j.should_rerank(d_j, intent)
        out_j = rr_j.rerank(QUERIES[0], d_j, intent, top_k=6)
        out_p = rr_p.rerank(QUERIES[0], d_p, intent, top_k=6)
        assert [d.doc_id for d in out_p] == [d.doc_id for d in out_j]
        np.testing.assert_allclose([d.score for d in out_p],
                                   [d.score for d in out_j], atol=TOL)
        np.testing.assert_allclose(
            [-1.0 if d.rerank_score is None else d.rerank_score
             for d in out_p],
            [-1.0 if d.rerank_score is None else d.rerank_score
             for d in out_j], atol=TOL)
    assert rr_p.stats == rr_j.stats
    assert rr_p.stats["skipped"] > 0
    assert rr_p.stats["reranked" if with_ce else "embedding_reranked"] > 0


def test_apply_mmr_and_rrf_merge_match_jax(services):
    svc_j, _, svc_p, _ = services
    rr_j = JaxReranker(embed_fn=svc_j.encode)
    rr_p = SelectiveReranker(embed_fn=svc_p.encode, device="cpu")
    for k, lam in ((3, 0.7), (5, 0.3), (12, 0.7)):
        got = rr_p.apply_mmr(_docs(10), k, lam=lam)
        want = rr_j.apply_mmr(_docs(10, cls=JaxDoc), k, lam=lam)
        assert [d.doc_id for d in got] == [d.doc_id for d in want]
    lists_p = [_docs(6), _docs(10)[3:], _docs(4)[::-1]]
    lists_j = [_docs(6, cls=JaxDoc), _docs(10, cls=JaxDoc)[3:],
               _docs(4, cls=JaxDoc)[::-1]]
    got = SelectiveReranker.rrf_merge(lists_p, 8)
    want = JaxReranker.rrf_merge(lists_j, 8)
    assert [d.doc_id for d in got] == [d.doc_id for d in want]
    np.testing.assert_allclose([d.score for d in got],
                               [d.score for d in want], atol=1e-12)


def test_rerank_config_is_the_jax_packages():
    from optimized_rag_tpu.config import RerankConfig as JaxRerankConfig
    from optimized_rag_tpu.config import Settings as JaxSettings
    assert dataclasses.asdict(RerankConfig()) == \
        dataclasses.asdict(JaxRerankConfig())
    assert Settings.env_var_names() == JaxSettings.env_var_names()
    env = {"ORAG_RERANK_BLEND_ORIGINAL": "0.4", "ORAG_TOP_K": "7"}
    assert dataclasses.asdict(Settings.from_env(env)) == \
        dataclasses.asdict(JaxSettings.from_env(env))


# ------------------------------------------------------ rerank_eval_fused

@pytest.mark.parametrize("mode", ["ce", "emb", "none"])
def test_rerank_eval_fused_matches_jax(services, mode):
    svc_j, ce_j, _, ce_p = services
    n, npad, k_mmr = 11, 16, 5
    embs = svc_j.encode([QUERIES[0]] + TEXTS[:n])
    doc_embs = np.zeros((npad, embs.shape[1]), np.float32)
    doc_embs[:n] = embs[1:]
    orig = np.zeros(npad, np.float32)
    orig[:n] = np.linspace(0.9, 0.2, n)
    valid = np.arange(npad) < n
    ids, mask, types = ce_p.tokenizer.encode_pairs(
        [(QUERIES[0], t) for t in TEXTS[:n]], 64)
    ids, mask, types = (np.pad(a, ((0, npad - n), (0, 0)))
                        for a in (ids, mask, types))
    want = np.asarray(j_rerank_eval_fused(
        ce_j.params, ids, mask, types, doc_embs, embs[0], orig, valid,
        np.float32(0.3), np.float32(0.7), k_mmr=k_mmr, mode=mode,
        ce_apply=ce_j._fwd))
    got = rerank_eval_fused(ce_p.model, ids, mask, types, doc_embs, embs[0],
                            orig, valid, 0.3, 0.7, k_mmr=k_mmr, mode=mode,
                            device="cpu").numpy()
    assert got.shape == want.shape == (5 + npad, npad)
    np.testing.assert_array_equal(got[2:4], want[2:4])    # order, MMR
    np.testing.assert_allclose(got, want, atol=TOL)


# ------------------------------------------------------- FusedRerankEval

FUSED_CASES = [
    ("matrix multiplication hardware", 5, Intent.QUESTION_ANSWERING, None),
    ("matrix multiplication systolic", 10, Intent.FACT_CHECKING, None),
    ("tell me about foxes and dogs", 10, Intent.CONVERSATIONAL, [0.5] * 10),
    ("chatting about bananas", 4, Intent.CONVERSATIONAL,
     [0.9, 0.8, 0.7, 0.6]),
    ("one clear winner", 10, Intent.CONVERSATIONAL,
     [0.95, 0.1, 0.08, 0.07, 0.06, 0.05, 0.04, 0.03, 0.02, 0.01]),
    ("index rows and certificates", 12, Intent.SEARCH, [0.5] * 12),
]


def _modular(query, docs, intent, svc, ce, k_mmr, lam=0.7):
    """The port's modular path: rerank, MMR, relevance, pairwise cosine."""
    rr = SelectiveReranker(cross_encoder=ce, embed_fn=svc.encode,
                           device="cpu")
    out = rr.rerank(query, docs, intent)
    out = rr.apply_mmr(out, k=min(k_mmr, len(out)), lam=lam)
    embs = torch.from_numpy(np.atleast_2d(svc.encode(
        [query] + [d.text for d in out])))
    rel01 = np.clip((cosine_matrix(embs[:1], embs[1:]).numpy()[0] + 1.0)
                    / 2.0, 0.0, 1.0)
    return out, rel01, cosine_matrix(embs[1:], embs[1:]).numpy(), rr.stats


@pytest.mark.parametrize("case", range(len(FUSED_CASES)))
def test_fused_rerank_eval_matches_jax_and_modular(services, case):
    query, n, intent, scores = FUSED_CASES[case]
    svc_j, ce_j, svc_p, ce_p = services
    rr_p = SelectiveReranker(cross_encoder=ce_p, embed_fn=svc_p.encode,
                             device="cpu")
    got = FusedRerankEval(rr_p, svc_p.encode, cross_encoder=ce_p).run(
        query, _docs(n, scores), intent, k_mmr=5, lam=0.7)
    want = JaxFused(JaxReranker(cross_encoder=ce_j, embed_fn=svc_j.encode),
                    svc_j.encode, cross_encoder=ce_j).run(
        query, _docs(n, scores, JaxDoc), intent, k_mmr=5, lam=0.7)
    assert [d.doc_id for d in got["docs"]] == \
        [d.doc_id for d in want["docs"]]
    np.testing.assert_allclose([d.score for d in got["docs"]],
                               [d.score for d in want["docs"]], atol=TOL)
    np.testing.assert_allclose(got["per_doc"], want["per_doc"], atol=TOL)
    assert abs(got["relevance"] - want["relevance"]) <= TOL
    assert got["sufficient"] == want["sufficient"]
    np.testing.assert_allclose(got["sim"], want["sim"], atol=TOL)

    mod_docs, mod_rel, mod_sim, mod_stats = _modular(
        query, _docs(n, scores), intent, svc_p, ce_p, 5)
    assert [d.doc_id for d in got["docs"]] == [d.doc_id for d in mod_docs]
    np.testing.assert_allclose([d.score for d in got["docs"]],
                               [d.score for d in mod_docs], atol=3e-5)
    np.testing.assert_allclose(got["per_doc"], mod_rel, atol=3e-5)
    np.testing.assert_allclose(got["sim"], mod_sim, atol=3e-5)
    assert rr_p.stats == mod_stats


def test_fused_rerank_eval_empty_and_buckets(services):
    from optimized_rag_tpu_torch.engine.fused import _bucket
    _, _, svc_p, ce_p = services
    fe = FusedRerankEval(SelectiveReranker(embed_fn=svc_p.encode,
                                           device="cpu"), svc_p.encode,
                         cross_encoder=ce_p)
    assert fe.run("q", [], Intent.SEARCH, 5, 0.7)["docs"] == []
    assert [_bucket(n) for n in (1, 8, 9, 16, 17, 33, 65)] == \
        [8, 8, 16, 16, 32, 64, 96]
