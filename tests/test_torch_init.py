"""The port's training-form initialisation against Flax's, on the CPU.

Every fresh tensor of each family (bi-encoder, cross-encoder, decoder LM,
grounded pointer-generator), drawn by ``models/encoder.flax_init_`` from a
``torch.Generator``, against the same tensor of the JAX package's Flax
init: its standard deviation within 10% and its mean within 10% of that
deviation (Dense kernels: lecun_normal; embeddings: std 1/sqrt(features));
biases zero and LayerNorm scales one, as Flax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.models import decoder as jd
from optimized_rag_tpu.models import encoder as je
from optimized_rag_tpu.models import grounded as jg
from optimized_rag_tpu_torch.models import decoder as pd
from optimized_rag_tpu_torch.models import encoder as pe
from optimized_rag_tpu_torch.models import grounded as pg
from optimized_rag_tpu_torch.models.encoder import training_module

import train_parity as tp

torch.set_num_threads(2)

WIDE = dict(hidden_dim=128, num_layers=2, num_heads=4, mlp_dim=256)
IDS = jnp.zeros((1, 8), jnp.int32)


def _jax_and_port(family):
    if family in ("biencoder", "crossencoder"):
        kw = dict(WIDE, vocab_size=1024, max_seq_len=64, out_dim=64)
        jc, pc = je.TransformerConfig(**kw), pe.TransformerConfig(**kw)
        if family == "biencoder":
            return (je.BiEncoder(jc).init(jax.random.PRNGKey(0), IDS,
                                          jnp.ones((1, 8), jnp.int32)),
                    lambda: pe.BiEncoder(pc, torch.float32), "encoder", pc)
        return (je.CrossEncoder(jc).init(jax.random.PRNGKey(0), IDS,
                                         jnp.ones((1, 8), jnp.int32), IDS),
                lambda: pe.CrossEncoder(pc, torch.float32), "encoder", pc)
    if family == "decoder":
        kw = dict(WIDE, max_seq_len=256)
        pc = pd.DecoderConfig(**kw)
        return (jd.DecoderLM(jd.DecoderConfig(**kw)).init(
            jax.random.PRNGKey(0), IDS),
            lambda: pd.DecoderLM(pc, torch.float32), "decoder", pc)
    kw = dict(WIDE, max_seq_len=256, copy_dim=64)
    jc, pc = jg.GroundedConfig(**kw), pg.GroundedConfig(**kw)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"backbone": jd.DecoderLM(jc).init(k1, IDS),
              "heads": jg.CopyHeads(jc.copy_dim).init(
                  k2, jnp.zeros((1, 8, jc.hidden_dim), jnp.float32))}
    return params, lambda: pg._Grounded(pc, torch.float32), "grounded", pc


@pytest.mark.parametrize("family", ["biencoder", "crossencoder", "decoder",
                                    "grounded"])
def test_fresh_tensors_match_flax_init_statistics(family):
    j_params, make, kind, pc = _jax_and_port(family)
    want = tp.flat(j_params)
    model = training_module(make, torch.device("cpu"), 0)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got = tp.port_flat(model.state_dict(), kind, pc)
    assert set(got) == set(want)
    checked = 0
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if key.endswith("bias"):
            assert not g.any() and not w.any(), key
        elif key.endswith("scale"):
            assert (g == 1).all() and (w == 1).all(), key
        else:
            assert abs(g.std() / w.std() - 1) < 0.1, (key, g.std(), w.std())
            assert abs(g.mean() - w.mean()) < 0.1 * w.std(), key
            if "embedding" not in key:     # truncated at two deviations
                fan_in = (w.shape[0] * w.shape[1] if "attn/out" in key
                          else w.shape[0])
                bound = 2 * np.sqrt(1.0 / fan_in) / .87962566103423978
                assert np.abs(g).max() <= bound * (1 + 1e-6), key
                assert np.abs(w).max() <= bound * (1 + 1e-6), key
            checked += 1
    assert checked >= 5


def test_init_is_seeded_and_leaves_the_global_stream_alone():
    pc = pe.TransformerConfig(vocab_size=256, hidden_dim=32, num_layers=1,
                              num_heads=4, mlp_dim=64, max_seq_len=16)
    torch.manual_seed(0)
    before = torch.rand(3)
    torch.manual_seed(0)
    a = training_module(lambda: pe.BiEncoder(pc, torch.float32), "cpu", 5)
    after = torch.rand(3)
    b = training_module(lambda: pe.BiEncoder(pc, torch.float32), "cpu", 5)
    assert torch.equal(before, after)
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    emb = a.trunk.emb.tok.weight
    assert abs(float(emb.detach().std()) * np.sqrt(32) - 1) < 0.1
