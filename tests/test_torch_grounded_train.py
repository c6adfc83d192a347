"""The port's GroundedTrainer and GroundedSampler against the JAX
package's, on the CPU.

The trainer starts from the JAX trainer's initial weights (backbone and
copy heads) and takes the same rows: left-padded prompts, PAD-tailed
targets, copy sources with -1 (unsupervised) among them, the early
positions weighted. In float32 two steps give nll and copy loss within
1e-5 relative and every weight within 1e-5 (attention-key biases apart:
``tests/train_parity.py``); in bfloat16 one step within 1e-2 and 2.5 lr.
The gradients are clipped to a global norm of 1 first, as optax chains
them. The sampler, a copy, gives the JAX package's rows from the same
seed exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.models import grounded as jg
from optimized_rag_tpu.models import grounded_data as jgd
from optimized_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from optimized_rag_tpu_torch.models import grounded as pg
from optimized_rag_tpu_torch.models import grounded_data as pgd
from optimized_rag_tpu_torch.parallel.mesh import make_mesh

import train_parity as tp

torch.set_num_threads(2)

LR = 3e-4


def _pair(dtype, **kw):
    jc, pc = tp.configs("grounded", dtype)
    ref = jg.GroundedTrainer(jc, jax_make_mesh(data=1, model=1),
                             prompt_len=tp.PROMPT, target_len=tp.TARGET,
                             **kw)
    port = pg.GroundedTrainer(pc, make_mesh(data=1, devices=["cpu"]),
                              prompt_len=tp.PROMPT, target_len=tp.TARGET,
                              **kw)
    port.params = tp.port_params(tp.flat(ref.params), "grounded", pc)
    return ref, port, pc


@pytest.mark.parametrize("early", [(8.0, 6), (1.0, 0)])
def test_grounded_trainer_two_steps_float32(rng, early):
    ref, port, pc = _pair("float32", early_weight=early[0],
                          early_len=early[1])
    for _ in range(2):
        args = tp.grounded_batch(rng)
        assert (args[2] == -1).any() and (args[2] >= 0).any()
        (j_nll, j_c), (p_nll, p_c) = ref.train_step(*args), \
            port.train_step(*args)
        assert isinstance(p_nll, float) and isinstance(p_c, float)
        np.testing.assert_allclose(p_nll, j_nll, rtol=tp.F32_LOSS_RTOL)
        np.testing.assert_allclose(p_c, j_c, rtol=tp.F32_LOSS_RTOL)
        assert float(port.last_grad_norm) > 1.0    # clipping was active
    tp.hold_weights(tp.flat(ref.params),
                    tp.port_flat(port.params, "grounded", pc),
                    tp.F32_WEIGHT_ATOL, pc.hidden_dim, LR, 2)


def test_grounded_trainer_one_step_bfloat16(rng):
    ref, port, pc = _pair("bfloat16")
    args = tp.grounded_batch(rng)
    (j_nll, j_c), (p_nll, p_c) = ref.train_step(*args), port.train_step(*args)
    np.testing.assert_allclose(p_nll, j_nll, rtol=tp.BF16_LOSS_RTOL)
    np.testing.assert_allclose(p_c, j_c, rtol=tp.BF16_LOSS_RTOL)
    tp.hold_weights(tp.flat(ref.params),
                    tp.port_flat(port.params, "grounded", pc),
                    tp.BF16_WEIGHT_LRS * LR, pc.hidden_dim, LR, 1)


def test_grounded_trainer_checks_its_lengths():
    _, pc = tp.configs("grounded", "float32")
    with pytest.raises(ValueError, match="max_seq_len"):
        pg.GroundedTrainer(pc, make_mesh(data=1, devices=["cpu"]),
                           prompt_len=60, target_len=16)


def _corpus():
    from optimized_rag_tpu.eval.qa_sheet import QA_DOCS_DIR
    import os
    texts = []
    for name in sorted(os.listdir(QA_DOCS_DIR)):
        with open(os.path.join(QA_DOCS_DIR, name), encoding="utf-8") as f:
            texts += [p for p in f.read().split("\n\n") if len(p) > 80]
    return texts


@pytest.mark.parametrize("prompt_len,target_len", [(2560, 320), (1792, 384),
                                                   (512, 96)])
def test_grounded_sampler_batches_equal_jax(prompt_len, target_len):
    texts = _corpus()
    j = jgd.GroundedSampler(texts, prompt_len=prompt_len,
                            target_len=target_len)
    p = pgd.GroundedSampler(texts, prompt_len=prompt_len,
                            target_len=target_len)
    assert p.sents == j.sents
    j_rng, p_rng = np.random.default_rng(5), np.random.default_rng(5)
    supervised = 0
    for _ in range(3):
        for a, b in zip(j.batch(j_rng, 8), p.batch(p_rng, 8)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        supervised += int((b >= 0).sum()) if b.ndim == 2 else 0
    assert supervised > 0
    for s in j.sents[0][:4]:
        q_rng, r_rng = np.random.default_rng(1), np.random.default_rng(1)
        assert pgd.make_question(q_rng, s) == jgd.make_question(r_rng, s)
        assert pgd.split_sentences(s) == jgd.split_sentences(s)


def test_train_grounded_matches_jax(monkeypatch):
    """``train_grounded`` (sampler, trainer and loop) from the JAX
    trainer's initial weights: two steps' nll and the weights after them
    equal JAX's run within the float32 tolerances."""
    from optimized_rag_tpu.models import pretrain as jp
    from optimized_rag_tpu_torch.models import pretrain as pp
    kw = dict(tp.GROUNDED, max_seq_len=608)
    jc = jg.GroundedConfig(**kw, dtype=jnp.float32)
    pc = pg.GroundedConfig(**kw, dtype=torch.float32)
    init = tp.flat(jg.GroundedTrainer(
        jc, jax_make_mesh(data=1, model=1), prompt_len=512,
        target_len=96, seed=3).params)          # train_grounded's init

    class FromJaxInit(pg.GroundedTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.params = tp.port_params(init, "grounded", pc)
    monkeypatch.setattr(pg, "GroundedTrainer", FromJaxInit)
    args = dict(steps=2, batch=2, prompt_len=512, target_len=96, seed=3)
    j_params, j_nll = jp.train_grounded(_corpus(), jc,
                                        jax_make_mesh(data=1, model=1),
                                        **args)
    p_params, p_nll = pp.train_grounded(
        _corpus(), pc, make_mesh(data=1, devices=["cpu"]), **args)
    np.testing.assert_allclose(p_nll, j_nll, rtol=tp.F32_LOSS_RTOL)
    tp.hold_weights(tp.flat(j_params),
                    tp.port_flat(p_params, "grounded", pc),
                    tp.F32_WEIGHT_ATOL, pc.hidden_dim, LR, 2)
