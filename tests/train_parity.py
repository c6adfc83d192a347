"""Shared pieces of the training parity tests: the small configurations of
both packages, seeded batches, and the hold of a port trainer's weights
against a JAX trainer's.

A trainer starts from the JAX trainer's initial weights (its Flax init,
carried across by ``models/convert.flax_to_torch``); after the steps both
weight sets go through the JAX layout (``convert.torch_to_flax``) and are
compared key by key. One class of weights is held apart: the biases of
attention keys (the encoders' ``attn/key/bias``, the key third of the
decoder's ``qkv/bias``, the copy heads' ``copy_k/bias``). A softmax is
unchanged when one number is added to all of its scores, so their gradient
is zero in exact arithmetic; in float32 each package computes rounding
noise there (about 1e-8), and Adam divides a gradient by its own running
magnitude, which turns noise of either sign into a step of up to about
``lr``. Those weights are held to ``2 * steps * lr`` and their port
gradients to NOISE_GRAD, the rest to the stated tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from optimized_rag_tpu.models import decoder as jd
from optimized_rag_tpu.models import grounded as jg
from optimized_rag_tpu.models.encoder import TransformerConfig as JConfig
from optimized_rag_tpu.models.loader import _flatten
from optimized_rag_tpu_torch.models import convert
from optimized_rag_tpu_torch.models import decoder as pd
from optimized_rag_tpu_torch.models import grounded as pg
from optimized_rag_tpu_torch.models.encoder import TransformerConfig as PConfig

F32_LOSS_RTOL = 1e-5
F32_WEIGHT_ATOL = 1e-5
BF16_LOSS_RTOL = 1e-2
BF16_WEIGHT_LRS = 2.5      # Adam's first step moves a weight by about lr
NOISE_GRAD = 1e-6
B, L, VOCAB = 8, 16, 512
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ENC = dict(vocab_size=VOCAB, hidden_dim=32, num_layers=2, num_heads=4,
           mlp_dim=64, max_seq_len=L, out_dim=32)
DEC = dict(hidden_dim=32, num_layers=2, num_heads=4, mlp_dim=64,
           max_seq_len=L)
GROUNDED = dict(hidden_dim=32, num_layers=2, num_heads=4, mlp_dim=64,
                max_seq_len=64, copy_dim=16)
PROMPT, TARGET = 48, 16


def configs(family: str, dtype: str):
    """(JAX config, port config) of the small configuration."""
    j, p = DTYPES[dtype]
    if family == "encoder":
        return JConfig(**ENC, dtype=j), PConfig(**ENC, dtype=p)
    if family == "decoder":
        return jd.DecoderConfig(**DEC, dtype=j), pd.DecoderConfig(**DEC,
                                                                dtype=p)
    return (jg.GroundedConfig(**GROUNDED, prompt_len=PROMPT,
                              target_len=TARGET, dtype=j),
            pg.GroundedConfig(**GROUNDED, prompt_len=PROMPT,
                              target_len=TARGET, dtype=p))


def flat(jax_params) -> dict:
    return {k: np.asarray(v, np.float32)
            for k, v in _flatten(jax.device_get(jax_params)).items()}


def port_params(flat_params: dict, family: str, cfg) -> dict:
    """The JAX trainer's weights as a port trainer's float32 state dict."""
    fn = {"encoder": convert.flax_to_torch,
          "decoder": convert.decoder_flax_to_torch,
          "grounded": convert.grounded_flax_to_torch}[family]
    return fn(flat_params, cfg, param_dtype=torch.float32)


def port_flat(params: dict, family: str, cfg) -> dict:
    fn = {"encoder": convert.torch_to_flax,
          "decoder": convert.decoder_torch_to_flax,
          "grounded": convert.grounded_torch_to_flax}[family]
    return fn(params, cfg)


def key_bias(key: str, hidden: int):
    """The index of ``key``'s attention-key biases, or None."""
    if key.endswith(("attn/key/bias", "copy_k/bias")):
        return ...
    if key.endswith("qkv/bias"):
        return slice(hidden, 2 * hidden)
    return None


def hold_weights(want: dict, got: dict, atol: float, hidden: int,
                 lr: float, steps: int, grads=None) -> dict:
    """Every weight of ``got`` within ``atol`` of ``want`` (same keys),
    attention-key biases within ``2 * steps * lr`` and their gradients
    (``grads``: flat key -> the port's last gradient) within NOISE_GRAD.
    Returns the largest difference of each class."""
    assert set(want) == set(got), set(want) ^ set(got)
    worst = {"weights": 0.0, "key_biases": 0.0}
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, (key, g.shape, w.shape)
        diff = np.abs(g.astype(np.float64) - w)
        part = key_bias(key, hidden)
        if part is not None:
            worst["key_biases"] = max(worst["key_biases"],
                                      float(diff[part].max()))
            assert diff[part].max() <= 2 * steps * lr, key
            if grads is not None:
                assert np.abs(grads[key][part]).max() <= NOISE_GRAD, key
            rest = np.ones(diff.shape, bool)
            rest[part] = False
            diff = diff[rest]
        if diff.size:
            worst["weights"] = max(worst["weights"], float(diff.max()))
            assert diff.max() <= atol, (key, float(diff.max()))
    return worst


def port_grads(trainer, family: str, cfg) -> dict:
    """The port trainer's last gradients in the JAX layout."""
    return port_flat({k: p.grad for k, p in trainer.model.named_parameters()},
                     family, cfg)


def encoder_batch(rng, b=B):
    """(q_ids, q_mask, d_ids, d_mask): token ids past the specials, query
    masks with padded tails."""
    q = rng.integers(4, VOCAB, (b, L)).astype(np.int32)
    d = rng.integers(4, VOCAB, (b, L)).astype(np.int32)
    qm = (np.arange(L)[None] < rng.integers(3, L + 1, (b, 1))).astype(
        np.int32)
    dm = (np.arange(L)[None] < rng.integers(6, L + 1, (b, 1))).astype(
        np.int32)
    return q * qm, qm, d * dm, dm


def pair_batch(rng, b=B):
    """(ids, mask, types, labels) of query-document pairs."""
    ids, mask, _, _ = encoder_batch(rng, b)
    types = (np.arange(L)[None] >= rng.integers(2, L - 2, (b, 1))).astype(
        np.int32) * mask
    labels = (np.arange(b) < b // 2).astype(np.float32)
    return ids, mask, types, labels


def byte_batch(rng, b=B, length=L):
    """Byte-level rows with PAD tails."""
    ids = rng.integers(3, 259, (b, length)).astype(np.int32)
    ids[:, 0] = pd.BOS
    keep = np.arange(length)[None] < rng.integers(4, length + 1, (b, 1))
    return np.where(keep, ids, pd.PAD).astype(np.int32)


def grounded_batch(rng, b=B):
    """(ids [B, P+T], pad_len [B], copy_tgt [B, T]) as the sampler lays
    them out: a left-padded prompt, a PAD-tailed target, copy sources where
    the target byte equals the prompt byte, -1 elsewhere."""
    ids = np.full((b, PROMPT + TARGET), pd.PAD, np.int32)
    pad_len = rng.integers(0, PROMPT // 2, b).astype(np.int32)
    copy_tgt = np.full((b, TARGET), -1, np.int32)
    for r in range(b):
        ids[r, pad_len[r]] = pd.BOS
        ids[r, pad_len[r] + 1:PROMPT] = rng.integers(
            3, 259, PROMPT - pad_len[r] - 1)
        n = int(rng.integers(4, TARGET))
        src = int(rng.integers(pad_len[r] + 1, PROMPT - n))
        ids[r, PROMPT:PROMPT + n] = ids[r, src:src + n]
        ids[r, PROMPT + n] = pd.EOS
        copy_tgt[r, :n] = np.arange(src, src + n)
        copy_tgt[r, rng.integers(0, n, 2)] = -1
    return ids, pad_len, copy_tgt
