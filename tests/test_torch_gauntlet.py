"""The port's encoder gauntlet against the JAX package's
``eval/encoder_gauntlet.py``, on the CPU.

``sample_spans`` and ``build_gauntlet`` over a seeded pool give the same
spans, queries, gold ids and index texts (host code, held for equality).
``run_gauntlet`` at a tiny size, with a small bi-encoder whose JAX
parameters are carried into the port by ``models/convert.flax_to_torch``
(float32 trunks, so the two services' embeddings agree within 1e-5) and the
harvest replaced by the same seeded pool, gives the same recalls and the
port's dense channel runs on ``DenseIndex.search``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.eval import encoder_gauntlet as jeg
from optimized_rag_tpu.models import corpus as jcorpus
from optimized_rag_tpu.models.encoder import (
    BiEncoder as JaxBiEncoder, EmbeddingService as JaxEmbed,
    TransformerConfig as JaxConfig)
from optimized_rag_tpu.models.loader import _flatten
from optimized_rag_tpu_torch.eval import encoder_gauntlet as peg
from optimized_rag_tpu_torch.index import dense
from optimized_rag_tpu_torch.models import corpus as pcorpus
from optimized_rag_tpu_torch.models.convert import flax_to_torch
from optimized_rag_tpu_torch.models.encoder import (
    EmbeddingService, TransformerConfig)

torch.set_num_threads(2)

WORDS = ("kernel fusion vector memory sparse retrieval ranks documents term "
         "frequency agent verifies claims cited sources training contrastive "
         "pairs batch negatives index cluster probe shard tile scan score "
         "latency throughput cache query answer citation verifier").split()
TINY = dict(vocab_size=512, hidden_dim=32, num_layers=1, num_heads=4,
            mlp_dim=64, max_seq_len=64, out_dim=32)


def _pool(rng, n):
    """``n`` seeded prose chunks of 20-40 words over a small vocabulary
    (lexically confusable), as the harvest's prose would be."""
    return [" ".join(WORDS[i] for i in rng.integers(0, len(WORDS),
                                                    int(rng.integers(20, 41))))
            + f" item {j}." for j in range(n)]


def test_sample_spans_matches_jax(rng):
    for text in _pool(rng, 30) + ["one two", "alpha beta gamma"]:
        seed = int(rng.integers(1 << 30))
        got = peg.sample_spans(np.random.default_rng(seed), text, 4)
        assert got == jeg.sample_spans(np.random.default_rng(seed), text, 4)
    assert peg.sample_spans(rng, "one two", 3) == []


@pytest.mark.parametrize("spans,negatives", [(2, 4), (4, 8)])
def test_build_gauntlet_matches_jax(rng, spans, negatives):
    pool, gold = _pool(rng, 200), _pool(rng, 12)
    got = peg.build_gauntlet(pool, gold, spans_per_chunk=spans,
                             negatives_per_query=negatives, seed=3,
                             device="cpu")
    want = jeg.build_gauntlet(pool, gold, spans_per_chunk=spans,
                              negatives_per_query=negatives, seed=3)
    assert got == want
    queries, q_gold, index_texts = got
    assert index_texts[:len(gold)] == gold and len(index_texts) > len(gold)
    assert len(queries) == len(q_gold) >= len(gold)


def _services():
    """A tiny float32 bi-encoder in both packages, the same weights."""
    jc = JaxConfig(**TINY, dtype=jnp.float32)
    params = JaxBiEncoder(jc).init(jax.random.PRNGKey(5),
                                   jnp.zeros((1, 8), jnp.int32),
                                   jnp.ones((1, 8), jnp.int32))
    flat = {k: np.asarray(v) for k, v in
            _flatten(jax.device_get(params)).items()}
    pc = TransformerConfig(**TINY, dtype=torch.float32)
    port = EmbeddingService(pc, params=flax_to_torch(flat, pc), max_len=64,
                            cache_size=0, device="cpu")
    ref = JaxEmbed(jc, params=params, max_len=64, cache_size=0)
    return port, ref


def test_run_gauntlet_matches_jax_at_a_tiny_size(rng, monkeypatch):
    big = _pool(rng, 360)            # prose[:300] gold, the rest the pool
    for mod in (jcorpus, pcorpus):
        monkeypatch.setattr(mod, "harvest_all",
                            lambda max_chunks=0, extra_dirs=(), **kw: big)
    searches = []
    search = dense.DenseIndex.search
    monkeypatch.setattr(dense.DenseIndex, "search", lambda self, *a, **kw: (
        searches.append(self.device), search(self, *a, **kw))[1])
    port, ref = _services()
    texts = big[:16]
    np.testing.assert_allclose(port.encode(texts), ref.encode(texts),
                               atol=1e-5)
    kw = dict(n_gold=24, spans_per_chunk=2, negatives_per_query=4,
              pool_chunks=360, seed=7)
    got = peg.run_gauntlet(port, **kw)
    want = jeg.run_gauntlet(ref, **kw)
    assert got == want
    assert got["n_queries"] == 48 and got["gold_chunks"] == 24
    assert searches and all(d.type == "cpu" for d in searches)
    assert 0 < got["recall_at_10_bm25"] <= 1
