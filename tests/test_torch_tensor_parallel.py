"""Tensor parallelism over the mesh's ``model`` axis, and training across
processes on ``dcn``: the port's trainers against the JAX package's, on
the CPU.

The JAX trainers run on ``make_mesh(data=4, model=2)`` and
``make_mesh(data=2, model=4)`` of the 8 virtual CPU devices (XLA splits
the layers by ``param_pspec`` and inserts the collectives); the port's on a
CPU mesh of the same shape (one device named eight times, so every layer
is split in two or four parts and their partial sums added). Each pair
starts from the JAX trainer's initial weights and takes three float32
steps on the same batches; losses are held within 1e-5 relative and
weights within 1e-5, attention-key biases within 2 x steps x lr
(``tests/train_parity.py``: the row-parallel sum adds the partial sums in
another order, which moves nothing past those bounds). The layout itself
(``shard_params``) is held against the JAX trainers' own shards.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from optimized_rag_tpu.models import grounded as jg
from optimized_rag_tpu.models import pretrain as jpre
from optimized_rag_tpu.models import training as jt
from optimized_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from optimized_rag_tpu_torch.models import grounded as pg
from optimized_rag_tpu_torch.models import pretrain as ppre
from optimized_rag_tpu_torch.models import training as pt
from optimized_rag_tpu_torch.parallel.mesh import make_mesh

import train_parity as tp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
STEPS = 3
MESHES = [(4, 2), (2, 4)]
TRAINERS = {  # family, JAX class, port class, batch maker, learning rate
    "biencoder": ("encoder", jt.BiEncoderTrainer, pt.BiEncoderTrainer,
                  tp.encoder_batch, 1e-4),
    "crossencoder": ("encoder", jt.CrossEncoderTrainer,
                     pt.CrossEncoderTrainer, tp.pair_batch, 1e-4),
    "decoder": ("decoder", jt.DecoderTrainer, pt.DecoderTrainer,
                lambda rng: (tp.byte_batch(rng),), 3e-4),
    "grounded": ("grounded", jg.GroundedTrainer, pg.GroundedTrainer,
                 tp.grounded_batch, 3e-4),
}
CASES = [(name, d, m) for name in sorted(TRAINERS) for d, m in MESHES]
_RUNS = {}


def _trainers(name, data, model):
    family, j_cls, p_cls, _, _ = TRAINERS[name]
    jc, pc = tp.configs(family, "float32")
    kw = ({"prompt_len": tp.PROMPT, "target_len": tp.TARGET}
          if family == "grounded" else {})
    ref = j_cls(jc, jax_make_mesh(data=data, model=model), **kw)
    port = p_cls(pc, make_mesh(data=data, model=model,
                               devices=[CPU] * (data * model)), **kw)
    port.params = tp.port_params(tp.flat(ref.params), family, pc)
    return ref, port, pc


def _run(name, data, model):
    """Both trainers after STEPS steps on the same seeded batches (each
    case once per module), the losses, and the JAX trainer's initial
    shards' shapes."""
    key = (name, data, model)
    if key not in _RUNS:
        ref, port, pc = _trainers(name, data, model)
        shards = {k: (tuple(v.addressable_shards[0].data.shape),
                      tuple(v.sharding.spec))
                  for k, v in _leaves(ref.params).items()}
        start = port.params
        rng = np.random.default_rng(7)
        losses = []
        for _ in range(STEPS):
            args = TRAINERS[name][3](rng)
            losses.append((ref.train_step(*args), port.train_step(*args)))
        _RUNS[key] = dict(ref=ref, port=port, pc=pc, losses=losses,
                          shards=shards, start=start)
    return _RUNS[key]


def _leaves(params) -> dict:
    """The JAX trainer's params (sharded jax.Arrays) by flat key."""
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["/".join(getattr(k, "key", str(k)) for k in path)] = leaf
    return out


def _port_name(flax_key: str) -> str:
    """The port's state-dict name of a flat Flax key."""
    parts = []
    for p in flax_key.split("/"):
        if p == "params":
            continue
        if p.startswith("block_"):
            parts += ["blocks", p[len("block_"):]]
        else:
            parts.append("weight" if p in ("kernel", "embedding") else p)
    return ".".join(parts)


@pytest.mark.parametrize("name,data,model", CASES)
def test_losses_match_jax_on_model_meshes(name, data, model):
    for want, got in _run(name, data, model)["losses"]:
        np.testing.assert_allclose(got, want, rtol=tp.F32_LOSS_RTOL)


@pytest.mark.parametrize("name,data,model", CASES)
def test_weights_match_jax_on_model_meshes(name, data, model):
    """Every weight after the steps within 1e-5 of JAX's (attention-key
    biases within 2 x steps x lr, their gradients noise), in the JAX
    layout, the port's params whole float32 tensors."""
    run = _run(name, data, model)
    family, lr = TRAINERS[name][0], TRAINERS[name][4]
    port, pc = run["port"], run["pc"]
    assert all(v.dtype == torch.float32 for v in port.params.values())
    grads = (None if family == "grounded" else
             tp.port_flat(port._grads(), family, pc))
    tp.hold_weights(tp.flat(run["ref"].params),
                    tp.port_flat(port.params, family, pc),
                    tp.F32_WEIGHT_ATOL, pc.hidden_dim, lr, STEPS, grads)


@pytest.mark.parametrize("name,data,model", CASES)
def test_shards_follow_param_pspec_on_every_leaf(name, data, model):
    """``shard_params``'s pieces against the JAX trainer's own shards: the
    same leaves split over ``model`` and the same piece on every leaf
    ([in, out] kernels as [out, in]); a model row round-trips through
    ``gather_params`` bit for bit."""
    run = _run(name, data, model)
    start = run["start"]
    sharded = pt.shard_params(start, run["port"].mesh)
    assert set(sharded) == set(start) == {_port_name(k)
                                          for k in run["shards"]}
    for key, (shape, spec) in run["shards"].items():
        pname = _port_name(key)
        assert (pt.split_rule(pname)[0] is not None) == ("model" in spec)
        if key.endswith("kernel"):
            n_in = 2 if len(shape) == 3 and key.endswith("out/kernel") else 1
            want = (int(np.prod(shape[n_in:])), int(np.prod(shape[:n_in])))
        for where in np.ndindex(sharded[pname].shape):
            piece = sharded[pname][where]
            assert piece.device == CPU
            if key.endswith("kernel"):
                assert tuple(piece.shape) == want, key
            else:
                assert piece.numel() == int(np.prod(shape)), key
    assert any("model" in spec for _, spec in run["shards"].values())
    gathered = pt.gather_params(sharded, run["port"].mesh)
    assert all(torch.equal(gathered[k], start[k]) for k in start)
    assert all(sharded[k][0, 0].data_ptr() != start[k].data_ptr()
               for k in start)


@pytest.mark.parametrize("family", ["decoder", "grounded"])
def test_fused_qkv_shards_hold_whole_heads(family):
    """The fused [3H, H] qkv splits each of its q, k and v thirds by heads
    (JAX's column split would give one device all of q at model=2); the
    gather gives back the whole kernel in JAX's order."""
    name = "decoder" if family == "decoder" else "grounded"
    run = _run(name, 2, 4)
    start, mesh, pc = run["start"], run["port"].mesh, run["pc"]
    prefix = "backbone." if family == "grounded" else ""
    whole = start[f"{prefix}blocks.0.qkv.weight"]
    sharded = pt.shard_params(start, mesh)[f"{prefix}blocks.0.qkv.weight"]
    width = pc.hidden_dim // 4
    assert width == pc.head_dim               # one head per device
    for m in range(4):
        piece = sharded[1, m]
        assert piece.shape == (3 * width, pc.hidden_dim)
        for g in range(3):
            rows = slice(g * pc.hidden_dim + m * width,
                         g * pc.hidden_dim + (m + 1) * width)
            assert torch.equal(piece[g * width:(g + 1) * width],
                               whole[rows])
    assert pt.split_rule(f"{prefix}blocks.0.qkv.weight") == (0, 3)
    assert pt.split_rule(f"{prefix}blocks.0.qkv.bias") == (None, 1)


@pytest.mark.parametrize("name", ["biencoder", "grounded"])
def test_checkpoint_after_a_tensor_parallel_step_reads_in_jax(name,
                                                              tmp_path):
    """``save_pretrained`` of a model=2 trainer's weights, read back by the
    JAX ``load_pretrained``: equal values under every key."""
    run = _run(name, 4, 2)
    family, pc = TRAINERS[name][0], run["pc"]
    ppre.save_pretrained(str(tmp_path), name, run["port"].params, pc)
    got = jpre.load_pretrained(str(tmp_path), name)
    assert got is not None
    flat = tp.flat(got[1])
    want = tp.port_flat(run["port"].params, family, pc)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])


def test_uneven_head_or_mlp_split_raises_naming_both_numbers():
    _, pc = tp.configs("encoder", "float32")
    with pytest.raises(ValueError, match=r"num_heads \(4\) and mlp_dim "
                                         r"\(64\) to divide by 3"):
        pt.BiEncoderTrainer(pc, make_mesh(data=1, model=3,
                                          devices=[CPU] * 3))
    _, dc = tp.configs("decoder", "float32")
    import dataclasses
    odd = dataclasses.replace(dc, mlp_dim=66)
    with pytest.raises(ValueError, match=r"mlp_dim \(66\)"):
        pt.DecoderTrainer(odd, make_mesh(data=1, model=4,
                                         devices=[CPU] * 4))


def test_model_parts_on_one_device_are_split_and_summed():
    """Both model positions on one device still make two parts and one sum
    (the card's smoke names one card twice)."""
    _, pc = tp.configs("encoder", "float32")
    port = pt.BiEncoderTrainer(pc, make_mesh(data=1, model=2,
                                             devices=[CPU] * 2))
    [(replica, pieces)] = port._replicas
    assert replica is port.model
    block = replica.trunk.blocks[0]
    assert len(block.attn.parts) == 2 and len(block.mlp.parts) == 2
    assert block.attn.parts[0].heads == pc.num_heads // 2
    w = pieces["trunk.blocks.0.attn.query.weight"][0]
    assert [tuple(p.shape) for p in w] == [(pc.hidden_dim // 2,
                                            pc.hidden_dim)] * 2
    assert w[0].data_ptr() != w[1].data_ptr()


@pytest.mark.parametrize("name,data,model", CASES)
def test_every_data_row_holds_its_own_copy_and_the_copies_stay_equal(
        name, data, model):
    """One copy per data row although every row names the same device:
    after the steps each copy's pieces and AdamW moments equal the first
    copy's bit for bit (the gradients were summed once and sent to
    every copy, and every copy stepped)."""
    port = _run(name, data, model)["port"]
    assert len(port._replicas) == data
    assert len({id(module) for module, _ in port._replicas}) == data
    first = pt._flat(port._replicas[0][1])
    for (_, pieces), opt in zip(port._replicas[1:], port._opt[1:]):
        flat = pt._flat(pieces)
        assert flat.keys() == first.keys()
        for key, p in flat.items():
            assert p.data_ptr() != first[key].data_ptr()
            assert torch.equal(p, first[key]), key
            for m in ("mu", "nu"):
                assert torch.equal(opt[m][key], port._opt[0][m][key]), key
        assert opt["count"] == port._opt[0]["count"] == STEPS


@pytest.mark.parametrize("name,data,model", CASES)
def test_no_model_position_holds_a_split_layer_whole(name, data, model):
    """The pieces are the trained parameters: at each model position a
    split weight's piece (and its two moments) is 1/model of the whole,
    the replicated weights lie once, at the first position, and no
    position holds the whole model."""
    port = _run(name, data, model)["port"]
    pieces = port._replicas[0][1]
    shapes = {k: v.shape for k, v in port.params.items()}
    held = [0] * model
    for (k, i), p in pt._flat(pieces).items():
        dim = pieces[k][1]
        whole = int(np.prod(shapes[k]))
        assert p.numel() == (whole if dim is None else whole // model), k
        assert port._opt[0]["mu"][(k, i)].shape == p.shape
        held[i] += p.numel()
    split = sum(int(np.prod(shapes[k])) for k, (_, dim, _) in pieces.items()
                if dim is not None)
    total = sum(int(np.prod(s)) for s in shapes.values())
    assert held[1:] == [split // model] * (model - 1)
    assert held[0] == total - split + split // model < total


_GLOO_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from optimized_rag_tpu_torch.models import training as pt
from optimized_rag_tpu_torch.models.encoder import TransformerConfig
from optimized_rag_tpu_torch.parallel import mesh

rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
try:
    z = np.load(path, allow_pickle=True)
    m = mesh.make_multihost_mesh(model=2, devices=[torch.device("cpu")] * 4)
    assert m.shape == {"dcn": 2, "data": 2, "model": 2}, m.shape
    cfg = TransformerConfig(**z["cfg"].item(), dtype=torch.float32)
    trainer = pt.BiEncoderTrainer(cfg, m)
    losses = [trainer.train_step(*z["batches"][s]) for s in range(2)]
    np.savez(path.replace(".npz", f"_rank{rank}.npz"), losses=losses,
             **{k: v.numpy() for k, v in trainer.params.items()})
finally:
    dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_on_dcn_end_with_the_one_process_weights(
        tmp_path):
    """A (dcn=2, data=2, model=2) mesh over two gloo processes: each runs
    its half of the batch, the per-row embeddings are all-gathered before
    the loss and the gradients all-reduced; both end with the same
    weights, and with the losses and weights of one process on a (data=4,
    model=2) mesh within ``tests/train_parity.py``'s bounds (the gradients
    are summed in another order)."""
    _, pc = tp.configs("encoder", "float32")
    rng = np.random.default_rng(11)
    batches = np.empty(2, object)
    batches[:] = [tp.encoder_batch(rng) for _ in range(2)]
    path = str(tmp_path / "in.npz")
    np.savez(path, cfg=np.array(tp.ENC, object), batches=batches)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_WORKER, str(r), str(port), path],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    one = pt.BiEncoderTrainer(pc, make_mesh(data=4, model=2,
                                            devices=[CPU] * 8))
    losses = [one.train_step(*b) for b in batches]
    want = tp.port_flat(one.params, "encoder", pc)
    ranks = [np.load(str(tmp_path / f"in_rank{r}.npz")) for r in range(2)]
    for got in ranks:
        np.testing.assert_allclose(got["losses"], losses,
                                   rtol=tp.F32_LOSS_RTOL)
        tp.hold_weights(want, tp.port_flat(
            {k: torch.from_numpy(got[k]) for k in one.params}, "encoder",
            pc), tp.F32_WEIGHT_ATOL, pc.hidden_dim, 1e-4, 2)
    for k in one.params:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
