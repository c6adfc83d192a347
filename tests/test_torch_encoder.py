"""Tokenizer and BiEncoder of the PyTorch port against the JAX package's.

Token ids must be identical. Embeddings agree within bf16 rounding: the
trunk computes in bfloat16 in both packages, which round at different
places (fused adds, the softmax's internal precision), so a cosine of at
least 0.9999 between the two packages' unit vectors is the bound; the
measured worst case on these inputs is about 0.99997.
"""

import glob
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import profile

from optimized_rag_tpu.models.encoder import EmbeddingService as JaxService
from optimized_rag_tpu.models.encoder import TransformerConfig as JaxConfig
from optimized_rag_tpu.models.loader import _flatten
from optimized_rag_tpu.models.pretrain import load_pretrained
from optimized_rag_tpu.models.pretrain import load_tokenizer as jax_tokenizer
from optimized_rag_tpu_torch.models.convert import (
    flax_to_torch, load_biencoder, load_tokenizer)
from optimized_rag_tpu_torch.models import encoder as encoder_mod
from optimized_rag_tpu_torch.models.encoder import (
    EmbeddingService, TransformerConfig)
from optimized_rag_tpu_torch.models.tokenizer import HashTokenizer
from optimized_rag_tpu_torch.utils import profiling

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "pretrained")
QA_DOCS = sorted(glob.glob(os.path.join(
    REPO, "optimized_rag_tpu", "eval", "qa_docs", "*.md")))
MIN_COSINE = 0.9999
QUERIES = ["How does the dense index handle deletes?",
           "What is the memory tier policy?",
           "Project Meridian budget and owners",
           "tpu hardware memory bandwidth",
           "hybrid search fusion weights"]


@pytest.fixture(scope="module")
def chunks():
    out = []
    for path in QA_DOCS:
        with open(path, encoding="utf-8") as f:
            out += [p.strip() for p in f.read().split("\n\n") if p.strip()]
    return out


@pytest.mark.parametrize("kind", ["vocab", "hash"])
def test_tokenizer_ids_match_jax(chunks, kind):
    from optimized_rag_tpu.models.tokenizer import HashTokenizer as JaxHash
    ckpt = CKPT if kind == "vocab" else None
    port = load_tokenizer(ckpt, 32768, 128)
    ref = jax_tokenizer(ckpt, 32768, 128)
    assert type(port).__name__ == type(ref).__name__
    assert isinstance(ref, JaxHash) and isinstance(port, HashTokenizer)
    texts = chunks + QUERIES + ["naïve café — ünïcode", ""]
    for t in texts:
        assert port.tokenize(t) == ref.tokenize(t)
    for a, b in zip(port.encode_batch(texts, 128),
                    ref.encode_batch(texts, 128)):
        np.testing.assert_array_equal(a, b)


def test_flax_to_torch_small_biencoder(chunks):
    """A flax-initialised 2-layer, 64-wide BiEncoder converted to torch."""
    kw = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4,
              mlp_dim=128, max_seq_len=128, out_dim=64)
    ref = JaxService(JaxConfig(**kw), seed=0, cache_size=0)
    cfg = TransformerConfig(**kw)
    port = EmbeddingService(cfg, params=flax_to_torch(_flatten(ref.params),
                                                      cfg),
                            cache_size=0, device="cpu")
    texts = chunks[:20] + QUERIES
    cos = np.sum(ref.encode(texts) * port.encode(texts), axis=1)
    assert cos.min() >= MIN_COSINE, cos.min()


def test_pretrained_biencoder_matches_jax(chunks):
    cfg, params = load_pretrained(CKPT, "biencoder")
    ref = JaxService(cfg, params=params, max_len=128, cache_size=0,
                     tokenizer=jax_tokenizer(CKPT, cfg.vocab_size, 128))
    port = load_biencoder(CKPT, device="cpu", cache_size=0)
    assert (port.cfg.num_layers, port.cfg.hidden_dim, port.cfg.num_heads) \
        == (6, 384, 12) and port.max_len == 128
    e_ref = ref.encode(chunks + QUERIES)
    e_port = port.encode(chunks + QUERIES)
    cos = np.sum(e_ref * e_port, axis=1)
    assert cos.min() >= MIN_COSINE, cos.min()
    n = len(chunks)
    for i in range(n, n + len(QUERIES)):
        top_ref = np.argsort(-(e_ref[:n] @ e_ref[i]), kind="stable")[:10]
        top_port = np.argsort(-(e_port[:n] @ e_port[i]), kind="stable")[:10]
        assert set(top_port) == set(top_ref)


def test_embedding_cache_and_buckets():
    svc = EmbeddingService(TransformerConfig(
        vocab_size=256, hidden_dim=32, num_layers=1, num_heads=2, mlp_dim=64,
        max_seq_len=32, out_dim=16), max_len=32, cache_size=2, device="cpu")
    a = svc.encode(["x y", "x y", "z"])
    np.testing.assert_array_equal(a[0], a[1])
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(svc.encode(["z"])[0], a[2])
    assert svc.cache_stats()["hits"] == 2 and svc._bucket_batch(33) == 64


def test_services_given_weights_hold_them_and_leave_the_generator():
    """A service given a state dict holds exactly those weights (torch's
    default initialisation skipped) and leaves the global generator as it
    was; without one, its weights are the seeded random init."""
    from optimized_rag_tpu_torch.models.encoder import CrossEncoderService
    cfg = TransformerConfig(vocab_size=256, hidden_dim=32, num_layers=1,
                            num_heads=2, mlp_dim=64, max_seq_len=32,
                            out_dim=16)
    for make in (EmbeddingService, CrossEncoderService):
        ref = make(cfg, seed=3, max_len=32, device="cpu")
        want = {k: v + 1 for k, v in ref.model.state_dict().items()}
        state = torch.random.get_rng_state()
        got = make(cfg, params=want, max_len=32, device="cpu")
        assert torch.equal(torch.random.get_rng_state(), state)
        assert not got.model.training
        for k, v in got.model.state_dict().items():
            assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
        again = make(cfg, seed=3, max_len=32, device="cpu")
        for k, v in again.model.state_dict().items():
            assert torch.equal(v, ref.model.state_dict()[k]), k


SMALL = dict(vocab_size=256, hidden_dim=32, num_layers=1, num_heads=2,
             mlp_dim=64, max_seq_len=128, out_dim=16)
WORDS = ("dense retrieval certified top-k tiles encoder batch queue host "
         "device stream kernel rescore fallback").split()


def _graph_texts(n: int, words: int, tag: str) -> list[str]:
    """``n`` distinct texts of ``words`` words (padded length: the ladder
    step above ``words`` + 2)."""
    rng = np.random.default_rng(len(tag) * 1000 + n * 10 + words)
    return [" ".join([f"{tag}{i}"] + list(rng.choice(WORDS, words - 1)))
            for i in range(n)]


class _CpuGraph(encoder_mod._ForwardGraph):
    """A stand-in for the CUDA graph on the CPU: "capture" keeps the model
    and takes ``like``'s pool token (a new one for a slot's first graph),
    and a replay runs the model on the static buffer into the static
    output, so a slot shared by two callers at once would hand one the
    other's vectors."""

    def _capture(self, model, like):
        self.model, self.pool = model, like.pool if like else object()
        return model(*self.tok)

    def replay(self):
        self.out.copy_(self.model(*self.tok))


def _eager_forward(svc, texts):
    """The eager forward written out: tokenize, pad to the bucket, the
    module on int64 ids."""
    ids, mask = svc.tokenizer.encode_batch(texts, svc.max_len)
    ids, mask = encoder_mod._pad_rows(
        (ids, mask), svc._bucket_batch(len(texts)))
    with torch.inference_mode():
        out = svc.model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    return out.float().numpy()[:len(texts)]


def test_cpu_service_never_captures_and_keeps_the_eager_vectors():
    svc = EmbeddingService(TransformerConfig(**SMALL), seed=4, max_len=128,
                           cache_size=0, device="cpu")
    assert svc._graph_type is None
    batches = [_graph_texts(5, 4, "a"), _graph_texts(33, 20, "b"),
               _graph_texts(130, 3, "c")]
    for texts in batches:
        np.testing.assert_array_equal(svc.encode(texts),
                                      _eager_forward(svc, texts))
    assert svc.graph_stats() == {"captures": 0, "replays": 0, "eager": 3}
    assert set(svc.cache_stats()) == {"hits", "misses", "hit_rate",
                                      "entries"}
    assert set(svc.stats) == {"hits", "misses"}


@pytest.mark.parametrize("max_len,ladder", [(128, (8, 16, 32, 64, 128)),
                                            (64, (8, 16, 32, 64))])
def test_graph_shapes_are_the_buckets_by_the_length_ladder(max_len, ladder):
    svc = EmbeddingService(TransformerConfig(**SMALL), max_len=max_len,
                           device="cpu")
    shapes = {(b, n) for b in range(1, 300) for n in range(1, 300)
              if svc.graphable(b, n)}
    assert shapes == {(b, n) for b in EmbeddingService.BATCH_BUCKETS
                      for n in ladder}
    assert not svc.graphable(256, 8) and not svc.graphable(256, max_len)
    # Every length the tokenizer pads to is on the ladder.
    for words in (1, 5, 6, 7, 14, 15, 30, 31, 62, 63, 126, 200):
        ids, _ = svc.tokenizer.encode_batch(_graph_texts(2, words, "w"),
                                            max_len)
        assert svc.graphable(8, ids.shape[1]), ids.shape


def test_graph_calls_from_two_threads_each_get_their_own_vectors():
    """Two threads through the stand-in graphs, each encoding its own
    texts at shapes the other uses too, get the vectors of a serial eager
    run; each shape has a graph a slot, each slot's graphs share a pool,
    the counts add up and a batch over 128 stays eager."""
    cfg = TransformerConfig(**SMALL)
    svc = EmbeddingService(cfg, seed=5, max_len=128, cache_size=0,
                           device="cpu")
    svc._graph_type = _CpuGraph
    ref = EmbeddingService(cfg, seed=5, max_len=128, cache_size=0,
                           device="cpu")
    work = {t: [_graph_texts(n, w, t) for n, w in
                ((3, 4), (20, 12), (8, 4), (50, 30), (6, 12), (31, 60))]
            for t in ("left", "right")}
    want = {t: [ref.encode(b) for b in bs] for t, bs in work.items()}
    rounds, got, errors = 6, {t: [] for t in work}, []

    def run(tag):
        try:
            for _ in range(rounds):
                got[tag].append([svc.encode(b) for b in work[tag]])
        except Exception as exc:   # reported below, with the thread's tag
            errors.append((tag, exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in work]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for tag in work:
        assert len(got[tag]) == rounds
        for vecs in got[tag]:
            for a, b in zip(vecs, want[tag]):
                np.testing.assert_array_equal(a, b)
    calls = 2 * rounds * 6
    shapes = {(svc._bucket_batch(n), svc.tokenizer.encode_batch(
        b, 128)[0].shape[1]) for bs in work.values() for b in bs
        for n in [len(b)]}
    assert svc.graph_stats() == {"captures": 2 * len(shapes),
                                 "replays": calls, "eager": 0}
    assert set(svc._graphs) == shapes
    # A pool a slot, shared by the slot's graphs.
    pools = [{id(gs[slot].pool) for gs in svc._graphs.values()}
             for slot in range(svc.GRAPH_SLOTS)]
    assert [len(p) for p in pools] == [1, 1] and pools[0] != pools[1]
    assert min(svc._replays) > 0
    big = _graph_texts(130, 4, "big")
    np.testing.assert_array_equal(svc.encode(big), ref.encode(big))
    assert svc.graph_stats()["eager"] == 1


def test_forward_span_notes_whether_a_graph_ran():
    svc = EmbeddingService(TransformerConfig(**SMALL), seed=6, max_len=128,
                           cache_size=0, device="cpu")
    t0 = time.perf_counter()
    with profile():
        svc.encode(_graph_texts(4, 5, "eager"))
        svc._graph_type = _CpuGraph
        svc.encode(_graph_texts(4, 5, "graph"))
        svc.encode(_graph_texts(4, 5, "again"))
        svc.encode(_graph_texts(200, 5, "wide"))
    recs = profiling.RECORDER.records(t0, time.perf_counter())
    assert [r.attrs for r in recs if r.name == "encode.forward"] == [
        {"graph": 0}, {"graph": 1}, {"graph": 1}, {"graph": 0}]
    assert svc.graph_stats() == {"captures": 2, "replays": 2, "eager": 2}
