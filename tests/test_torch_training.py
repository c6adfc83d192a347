"""The port's trainers, AdamW and losses against the JAX package's
``models/training.py`` and optax, on the CPU.

Each trainer starts from the JAX trainer's initial weights and takes the
same numpy batches. In float32 configurations (both sides) three steps
give losses within 1e-5 relative and weights within 1e-5 absolute
(attention-key biases apart: ``tests/train_parity.py``). In bfloat16 one
step gives the loss within 1e-2 relative and every weight within 2.5 lr.
A data=4 mesh (four logical CPU devices) holds the JAX trainer on four of
its eight virtual devices and the port's one-device step; a model=2 mesh
and a one-process multi-host mesh take the one-device step too
(``tests/test_torch_tensor_parallel.py`` holds the model axis against the
JAX trainers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from optimized_rag_tpu.models import decoder as jd
from optimized_rag_tpu.models import encoder as je
from optimized_rag_tpu.models import training as jt
from optimized_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from optimized_rag_tpu_torch.models import training as pt
from optimized_rag_tpu_torch.parallel.mesh import make_mesh

import train_parity as tp

torch.set_num_threads(2)

CPU = torch.device("cpu")
TRAINERS = {  # family, JAX class, port class, batch maker, learning rate
    "biencoder": ("encoder", jt.BiEncoderTrainer, pt.BiEncoderTrainer,
                  tp.encoder_batch, 1e-4),
    "crossencoder": ("encoder", jt.CrossEncoderTrainer,
                     pt.CrossEncoderTrainer, tp.pair_batch, 1e-4),
    "decoder": ("decoder", jt.DecoderTrainer, pt.DecoderTrainer,
                lambda rng: (tp.byte_batch(rng),), 3e-4),
}


def port_mesh(data=1):
    return make_mesh(data=data, devices=[CPU] * data)


def _pair(name, dtype, data=1):
    family, j_cls, p_cls, batch, lr = TRAINERS[name]
    jc, pc = tp.configs(family, dtype)
    ref = j_cls(jc, jax_make_mesh(data=data, model=1))
    port = p_cls(pc, port_mesh(data))
    port.params = tp.port_params(tp.flat(ref.params), family, pc)
    return ref, port, pc, batch, lr, family


# ----------------------------------------------------------------- losses

def test_info_nce_loss_value_and_gradient(rng):
    q = rng.standard_normal((8, 16)).astype(np.float32)
    d = rng.standard_normal((8, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want, (gq, gd) = jax.value_and_grad(jt.info_nce_loss, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(d))
    tq = torch.from_numpy(q).requires_grad_()
    td = torch.from_numpy(d).requires_grad_()
    got = pt.info_nce_loss(tq, td)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), atol=1e-6)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd), atol=1e-6)
    perfect = pt.info_nce_loss(torch.eye(8), torch.eye(8), 0.05)
    assert float(perfect) < 1e-3


def test_sigmoid_bce_matches_optax(rng):
    x = rng.standard_normal(64).astype(np.float32) * 4
    y = (rng.random(64) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        pt.sigmoid_binary_cross_entropy(torch.from_numpy(x),
                                        torch.from_numpy(y)).numpy(),
        np.asarray(optax.sigmoid_binary_cross_entropy(x, y)), atol=1e-6)


def test_param_pspec_matches_jax():
    """The layout record: the same spec for every leaf of each family's
    Flax tree."""
    trees = [
        je.BiEncoder(tp.configs("encoder", "float32")[0]).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
            jnp.ones((1, 8), jnp.int32)),
        jd.DecoderLM(tp.configs("decoder", "float32")[0]).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))]
    seen = set()
    for tree in trees:
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            want = tuple(jt.param_pspec(path, leaf))
            key = "/".join(k.key for k in path)
            assert pt.param_pspec(path, leaf) == want, key
            assert pt.param_pspec(key, leaf) == want, key
            seen.add(want)
    assert {(), (None, "model"), (None, "model", None),
            ("model", None, None), ("model", None)} <= seen


# ----------------------------------------------------------- the optimizer

def _optax_run(tx, params, grads_seq):
    state = tx.init(params)
    for g in grads_seq:
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params


def _port_run(tx, params, grads_seq, state=None):
    p = {k: torch.tensor(v) for k, v in params.items()}
    state = state or tx.init(p)
    norms = []
    for g in grads_seq:
        norms.append(tx.update_(p, {k: torch.tensor(v) for k, v in g.items()},
                                state))
    return {k: v.numpy() for k, v in p.items()}, state, norms


def _params_and_grads(rng, steps, scale=1.0):
    shapes = {"w": (6, 5), "b": (5,), "e": (7, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(steps)]
    grads[1]["b"][:] = 0.0          # a zero gradient still decays
    return params, grads


@pytest.mark.parametrize("schedule", ["constant", "callable"])
def test_adamw_matches_optax(rng, schedule):
    """optax.adamw's defaults (weight decay 1e-4 on every leaf) and a
    callable learning rate called with the count of updates made."""
    lr = 3e-3 if schedule == "constant" else (
        lambda count: 1e-3 * (1.0 + count))
    params, grads = _params_and_grads(rng, 5)
    want = _optax_run(optax.adamw(lr), params, grads)
    got, state, norms = _port_run(pt.AdamW(lr), params, grads)
    assert state["count"] == 5 and norms == [None] * 5
    for k in params:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_raises(AssertionError, np.testing.assert_allclose,
                             got["w"], params["w"], atol=1e-4)


def test_adamw_resume_shift_matches_a_shifted_optax_schedule(rng):
    """The resume path: a fresh optimizer after ``start`` steps with the
    schedule shifted by ``start`` (pretrain.train_biencoder's lr)."""
    from optimized_rag_tpu_torch.models.pretrain import _shifted
    sched = lambda count: 1e-3 / (1.0 + count)  # noqa: E731
    start = 3
    params, grads = _params_and_grads(rng, 4)
    want = _optax_run(optax.adamw(
        lambda count: sched(count + start)), params, grads)
    got, _, _ = _port_run(pt.AdamW(_shifted(sched, start)), params, grads)
    for k in params:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7)
    assert _shifted(1e-3, start) == 1e-3 and _shifted(sched, 0) is sched


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_then_adamw_matches_optax_chain(rng, scale):
    """optax.clip_by_global_norm(1.0) then adamw (GroundedTrainer's chain),
    with the global norm below 1 (kept) and above it (scaled)."""
    params, grads = _params_and_grads(rng, 3, scale)
    want = _optax_run(optax.chain(optax.clip_by_global_norm(1.0),
                                  optax.adamw(3e-4)), params, grads)
    got, _, norms = _port_run(pt.AdamW(3e-4, clip_norm=1.0), params, grads)
    for k in params:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7)
    for g, n in zip(grads, norms):
        np.testing.assert_allclose(float(n), float(optax.global_norm(g)),
                                   rtol=1e-6)
        assert (float(n) < 1.0) == (scale < 1.0)
    g = {k: torch.tensor(v) for k, v in grads[0].items()}
    before = {k: v.clone() for k, v in g.items()}
    pt.clip_by_global_norm(list(g.values()), 1.0)
    want_g, _ = optax.clip_by_global_norm(1.0).update(grads[0], None)
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(want_g[k]),
                                   rtol=1e-6)
        assert torch.equal(g[k], before[k]) == (scale < 1.0)


# -------------------------------------------------------------- the trainers

@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_three_steps_float32(name, rng):
    ref, port, pc, batch, lr, family = _pair(name, "float32")
    for _ in range(3):
        args = batch(rng)
        before = port.batch_loss(*args)       # no step
        want, got = ref.train_step(*args), port.train_step(*args)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=tp.F32_LOSS_RTOL)
        np.testing.assert_allclose(before, got, rtol=1e-6)
    tp.hold_weights(tp.flat(ref.params),
                    tp.port_flat(port.params, family, pc),
                    tp.F32_WEIGHT_ATOL, pc.hidden_dim, lr, 3,
                    tp.port_grads(port, family, pc))


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_one_step_bfloat16(name, rng):
    ref, port, pc, batch, lr, family = _pair(name, "bfloat16")
    args = batch(rng)
    want, got = ref.train_step(*args), port.train_step(*args)
    np.testing.assert_allclose(got, want, rtol=tp.BF16_LOSS_RTOL)
    assert all(v.dtype == torch.float32 for v in port.params.values())
    tp.hold_weights(tp.flat(ref.params),
                    tp.port_flat(port.params, family, pc),
                    tp.BF16_WEIGHT_LRS * lr, pc.hidden_dim, lr, 1)


@pytest.mark.parametrize("name", ["biencoder", "decoder"])
def test_data4_mesh_matches_jax_and_one_device(name, rng):
    """A data=4 mesh of four logical CPU devices: the JAX trainer on four
    of the eight virtual devices, and the port's one-device step from the
    same weights (InfoNCE over the global batch's negatives)."""
    ref, port, pc, batch, lr, family = _pair(name, "float32", data=4)
    one = TRAINERS[name][2](pc, port_mesh(1))
    one.params = port.params
    for _ in range(2):
        args = batch(rng)
        want = ref.train_step(*args)
        got, single = port.train_step(*args), one.train_step(*args)
        np.testing.assert_allclose(got, want, rtol=tp.F32_LOSS_RTOL)
        np.testing.assert_allclose(got, single, rtol=tp.F32_LOSS_RTOL)
    tp.hold_weights(tp.flat(ref.params),
                    tp.port_flat(port.params, family, pc),
                    tp.F32_WEIGHT_ATOL, pc.hidden_dim, lr, 2)
    tp.hold_weights(tp.port_flat(one.params, family, pc),
                    tp.port_flat(port.params, family, pc),
                    tp.F32_WEIGHT_ATOL, pc.hidden_dim, lr, 2)
    with pytest.raises(ValueError, match="does not split"):
        port.train_step(*[a[:6] for a in batch(rng)])


def test_model_axis_step_and_dcn_mesh_on_one_process(rng):
    """A model=2 mesh (two head parts on one device, their partial sums
    added) and a multi-host mesh of one process (dcn=1, its data rows this
    process's) each take the one-device steps; a dcn axis above 1 needs a
    process group of that size."""
    from optimized_rag_tpu_torch.parallel.mesh import (
        Mesh, make_multihost_mesh)
    _, pc = tp.configs("encoder", "float32")
    one = pt.BiEncoderTrainer(pc, port_mesh())
    mesh = make_multihost_mesh(devices=[CPU] * 2)
    assert mesh.shape == {"dcn": 1, "data": 2, "model": 1}
    assert pt.data_rows(mesh) == [[CPU], [CPU]]
    split = pt.BiEncoderTrainer(pc, make_mesh(data=1, model=2,
                                              devices=[CPU] * 2))
    hosts = pt.BiEncoderTrainer(pc, mesh)
    split.params = hosts.params = one.params
    for _ in range(2):
        args = tp.encoder_batch(rng)
        want = one.train_step(*args)
        for other in (split, hosts):
            np.testing.assert_allclose(other.train_step(*args), want,
                                       rtol=tp.F32_LOSS_RTOL)
    for other in (split, hosts):
        tp.hold_weights(tp.port_flat(one.params, "encoder", pc),
                        tp.port_flat(other.params, "encoder", pc),
                        tp.F32_WEIGHT_ATOL, pc.hidden_dim, 1e-4, 2)
    two = Mesh(np.concatenate([mesh.devices, mesh.devices]),
               mesh.axis_names)
    assert two.shape == {"dcn": 2, "data": 2, "model": 1}
    with pytest.raises(ValueError, match="torch.distributed group of 2"):
        pt.BiEncoderTrainer(pc, two)


def test_trainers_start_from_flax_init_on_their_device():
    """No torch default init: Flax's distributions from the seed's
    generator, float32 master weights, reproducible per seed."""
    _, pc = tp.configs("encoder", "bfloat16")
    a = pt.BiEncoderTrainer(pc, port_mesh(), seed=3).params
    b = pt.BiEncoderTrainer(pc, port_mesh(), seed=3).params
    c = pt.BiEncoderTrainer(pc, port_mesh(), seed=4).params
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["trunk.emb.tok.weight"],
                           c["trunk.emb.tok.weight"])
    assert all(v.dtype == torch.float32 and v.device == CPU
               for v in a.values())
    assert float(a["trunk.blocks.0.attn.query.bias"].abs().max()) == 0.0
