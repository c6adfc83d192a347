"""Tokenizer and BiEncoder of the PyTorch port against the JAX package's.

Token ids must be identical. Embeddings agree within bf16 rounding: the
trunk computes in bfloat16 in both packages, which round at different
places (fused adds, the softmax's internal precision), so a cosine of at
least 0.9999 between the two packages' unit vectors is the bound; the
measured worst case on these inputs is about 0.99997.
"""

import glob
import os

import numpy as np
import pytest
import torch

from optimized_rag_tpu.models.encoder import EmbeddingService as JaxService
from optimized_rag_tpu.models.encoder import TransformerConfig as JaxConfig
from optimized_rag_tpu.models.loader import _flatten
from optimized_rag_tpu.models.pretrain import load_pretrained
from optimized_rag_tpu.models.pretrain import load_tokenizer as jax_tokenizer
from optimized_rag_tpu_torch.models.convert import (
    flax_to_torch, load_biencoder, load_tokenizer)
from optimized_rag_tpu_torch.models.encoder import (
    EmbeddingService, TransformerConfig)
from optimized_rag_tpu_torch.models.tokenizer import HashTokenizer

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
