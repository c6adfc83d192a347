"""Training for the retrieval models and the decoder LM on a device mesh.

Held against ``optimized_rag_tpu/models/training.py`` (:35-242). The
objectives are the JAX package's: symmetric InfoNCE over in-batch negatives
for the bi-encoder, pointwise sigmoid cross-entropy for the cross-encoder,
next-token cross-entropy for the decoder LM, each minimised by AdamW as
``optax.adamw`` computes it.

The JAX trainers ``jit`` one step with sharding annotations and XLA inserts
the collectives; the sharding changes where the work runs, not what is
computed. Here one process drives its devices, and the mesh's axes are:

* ``data``: the batch is split in equal row blocks, one per data row of
  the mesh; each row runs forward and backward on its own copy of the
  weights (rows that name the same devices still hold a copy each); the
  per-row outputs (the bi-encoder's embeddings, the tokens' log-probs)
  meet on the first device before the loss, so the loss is the one-device
  loss over the global batch (InfoNCE keeps every in-batch negative); the
  gradients are all-reduced over the rows (summed, in row order, into the
  first row's copy, which sends the sum back to every other), and every
  copy takes the same AdamW step with its own moments, so the copies stay
  equal.
* ``model``: tensor parallelism, laid out by ``param_pspec``. In a row's
  copy each block's attention and MLP run over the row's model devices:
  each model device holds whole heads (its q/k/v kernel rows and biases;
  the decoder's fused ``qkv`` split by heads in each of its thirds) and a
  block of MLP columns (``mlp_in`` rows and bias), and the matching input
  columns of the row-parallel ``out`` / ``attn_out`` and ``mlp_out``. The
  parts' outputs are summed on the row's first device (the all-reduce),
  then the row layer's bias is added once; autograd's transpose of that sum
  (and of the copies of the input to each device) is the backward's
  collective. Everything else stays on the row's first device, once. The
  pieces are the trained parameters: each has its AdamW moments beside it
  on its device, and no device holds a split layer whole (the whole
  tensors are joined only for ``params``, ``opt_state`` and checkpoints).
  A row that names one device several times still splits: two parts on
  one card are two partial sums and one sum, which tests the code path,
  not NVLink.
  ``num_heads`` and ``mlp_dim`` must divide by the axis (JAX's
  ``device_put`` refuses an uneven split too).
* ``dcn``: one position per process of the ``torch.distributed`` group
  (``parallel/mesh.make_multihost_mesh``; gloo on the CPU, NCCL across
  cards). Every process is given the global batch and runs its own rows'
  blocks; what crosses the processes is the per-row outputs (an all-gather
  before the loss, so every process computes the one-process loss) and the
  gradients (one all-reduce a step for each model position, of the pieces
  there). Every process then takes the same step and holds the same
  weights.

``shard_params`` places a state dict on the mesh in ``param_pspec``'s
layout and ``gather_params`` is its inverse; the trainers' ``params`` are
whole float32 tensors in the port's layout of the JAX parameters.

Weights are float32 (``param_dtype=torch.float32``), cast to
``cfg.dtype`` at each use as Flax casts them, and start from Flax's
initialisers (``models/encoder.flax_init_``) drawn from a
``torch.Generator`` seeded with ``seed``; ``jax.random``'s stream cannot be
matched, so set ``params`` to start from given weights. TF32 stays off.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from optimized_rag_tpu_torch.models import decoder as _decoder
from optimized_rag_tpu_torch.models.encoder import (
    BiEncoder, CrossEncoder, Linear, TransformerConfig, _Attention, _Block,
    gelu, training_module)


# ---------------------------------------------------------------------------
# Parameter layout (tensor parallelism) and the mesh's data devices
# ---------------------------------------------------------------------------

def param_pspec(path, leaf) -> tuple:
    """The JAX package's PartitionSpec of one parameter, as a tuple, keyed
    on its Flax path (``"params/trunk/block_0/attn/query/kernel"`` or a
    sequence of names).

    Column-parallel: attention q/k/v kernels, mlp_in  (split output dim)
    Row-parallel:    attention out kernel,   mlp_out  (split input dim)
    Everything else (embeddings, layernorms, biases, heads) replicated.
    """
    names = path.split("/") if isinstance(path, str) else [
        getattr(k, "key", str(k)) for k in path]
    joined = "/".join(names)
    ndim = getattr(leaf, "ndim", 0)
    if "qkv" in joined and "kernel" in joined:
        return (None, "model")           # decoder fused qkv [H, 3H]
    if "attn" in joined and "kernel" in joined:
        if "out" in joined:
            # [heads, head_dim, hidden]: split heads (row-parallel input)
            return ("model", None, None) if ndim == 3 else ("model", None)
        # query/key/value kernels [hidden, heads, head_dim]: split heads
        return (None, "model", None) if ndim == 3 else (None, "model")
    if "mlp_in" in joined and "kernel" in joined:
        return (None, "model")
    if "mlp_out" in joined and "kernel" in joined:
        return ("model", None)
    return ()


def split_rule(name: str) -> tuple:
    """``param_pspec`` in the port's layout: (dim, groups) of the weight
    ``name`` of a state dict, where ``dim`` of the tensor is split over the
    ``model`` axis and ``groups`` equal parts of it are split alike; (None,
    1) where it is replicated. The port's kernels are [out, in], so a
    column-parallel kernel splits dim 0 and a row-parallel one dim 1. The
    decoder's fused ``qkv`` [3H, H] splits each of its q, k and v thirds by
    heads (groups 3): JAX's ``P(None, "model")`` cuts [H, 3H] in contiguous
    columns, which at model=2 gives one device all of q and half of k, and
    XLA reshards behind it; the port's layout keeps whole heads on each
    device, and the whole tensor (and every checkpoint) is the same."""
    *path, module, leaf = name.split(".")
    attn = path[-1:] == ["attn"]
    if leaf != "weight":
        return None, 1
    if module == "qkv":
        return 0, 3
    if module == "mlp_in" or (attn and module in ("query", "key", "value")):
        return 0, 1
    if module in ("attn_out", "mlp_out") or (attn and module == "out"):
        return 1, 1
    return None, 1


def _split(t: torch.Tensor, dim, groups: int, n: int) -> list:
    """``n`` pieces of ``t`` by ``split_rule``'s (dim, groups)."""
    if dim is None:
        return [t] * n
    chunks = [g.chunk(n, dim) for g in t.chunk(groups, dim)]
    return [torch.cat([c[m] for c in chunks], dim) for m in range(n)]


def _join(pieces: list, dim, groups: int) -> torch.Tensor:
    """The inverse of ``_split`` (on the first piece's device)."""
    if dim is None:
        return pieces[0]
    at = pieces[0].device
    parts = [p.to(at).chunk(groups, dim) for p in pieces]
    return torch.cat([torch.cat([p[g] for p in parts], dim)
                      for g in range(groups)], dim)


@dataclasses.dataclass(frozen=True)
class ParamSharding:
    """Where one weight lives on ``mesh``: ``split_rule``'s (dim, groups)
    over the ``model`` axis, copies over every other axis (the port's
    ``NamedSharding(mesh, param_pspec(...))``)."""
    mesh: object
    dim: int | None
    groups: int = 1


def param_shardings(state: dict, mesh) -> dict:
    """name -> ``ParamSharding`` of every weight of ``state``."""
    return {name: ParamSharding(mesh, *split_rule(name)) for name in state}


def shard_params(state: dict, mesh) -> dict:
    """Place ``state`` (name -> whole tensor) on the mesh with the
    tensor-parallel layout: name -> an object array shaped like
    ``mesh.devices`` holding, at each of this process's devices, that
    device's piece (a copy), and None at other processes' devices."""
    axis = mesh.axis_names.index("model")
    n = mesh.shape["model"]
    out = {}
    for name, sh in param_shardings(state, mesh).items():
        pieces = _split(state[name].detach(), sh.dim, sh.groups, n)
        grid = np.empty(mesh.devices.shape, object)
        for where in np.ndindex(grid.shape):
            if mesh.process_ids[where] == mesh.process_index:
                grid[where] = pieces[where[axis]].to(mesh.devices[where],
                                                     copy=True)
        out[name] = grid
    return out


def gather_params(sharded: dict, mesh) -> dict:
    """The inverse of ``shard_params``: name -> the whole tensor, joined
    from the first model row this process holds, on its first device."""
    axis = mesh.axis_names.index("model")
    out = {}
    for name, grid in sharded.items():
        dim, groups = split_rule(name)
        first = next(w for w in np.ndindex(grid.shape)
                     if grid[w] is not None)
        row = [grid[first[:axis] + (m,) + first[axis + 1:]]
               for m in range(grid.shape[axis])]
        out[name] = _join(row, dim, groups)
    return out


def data_rows(mesh) -> list:
    """This process's data rows of ``mesh`` in order, each the list of its
    model devices (one per position of the ``model`` axis)."""
    grid = mesh.devices
    if "dcn" in mesh.axis_names:
        grid = np.take(grid, mesh.process_index,
                       axis=mesh.axis_names.index("dcn"))
    order = [a for a in mesh.axis_names if a != "dcn"]
    grid = np.transpose(grid, [order.index("data"), order.index("model")])
    return [[torch.device(d) for d in row] for row in grid]


# ---------------------------------------------------------------------------
# Tensor parallelism over the model axis
# ---------------------------------------------------------------------------

class _Parallel(nn.Module):
    """A column- then row-parallel sublayer: each part, on its own device,
    takes a copy of the input and computes its heads (or MLP columns)
    through its columns of the row layer; the parts' outputs are summed on
    the input's device (the all-reduce) and the row layer's ``bias`` is
    added once."""

    def __init__(self, parts, bias: nn.Parameter):
        super().__init__()
        self.parts = nn.ModuleList(parts)
        self.bias = bias

    def forward(self, x, *args):
        total = None
        for part in self.parts:
            dev = next(part.parameters()).device
            y = part(x.to(dev), *(a if a is None else a.to(dev)
                                  for a in args)).to(x.device)
            total = y if total is None else total + y
        return total + self.bias.to(total.dtype)


class _MLPPart(nn.Module):
    """A block of MLP columns: ``mlp_out(act(mlp_in(h)))`` with no output
    bias."""

    def __init__(self, mlp_in, mlp_out, act):
        super().__init__()
        self.mlp_in, self.mlp_out, self.act = mlp_in, mlp_out, act

    def forward(self, h):
        return self.mlp_out(self.act(self.mlp_in(h)))


class _CausalHeads(nn.Module):
    """Some of a decoder block's heads: its rows of the fused ``qkv`` (whole
    heads of q, k and v), causal attention, and its columns of
    ``attn_out`` (no bias); ``models/decoder._CausalBlock``'s function."""

    def __init__(self, cfg, heads: int, dtype):
        super().__init__()
        width = heads * cfg.head_dim
        self.cfg, self.heads = cfg, heads
        self.scale = float(np.float32(1.0 / np.sqrt(cfg.head_dim)))
        self.qkv = _decoder.Dense(cfg.hidden_dim, 3 * width, dtype=dtype)
        self.attn_out = _decoder.Dense(width, cfg.hidden_dim, bias=False,
                                       dtype=dtype)

    def forward(self, h, key_valid):
        b, length, _ = h.shape
        q, k, v = _decoder.split_qkv(self.qkv(h), self.heads)
        out = _decoder.attend(q, k, v,
                              _decoder.causal_mask(length, key_valid,
                                                   h.device),
                              self.scale, self.cfg.dtype)
        return self.attn_out(out.reshape(b, length, -1))


class _ParallelBlock(nn.Module):
    """``models/encoder._Block`` with its attention and MLP over the model
    devices."""

    def __init__(self, ln1, attn: _Parallel, ln2, mlp: _Parallel):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp

    def forward(self, x, mask):
        dt = x.dtype
        x = x + self.attn(self.ln1(x).to(dt), mask)
        return x + self.mlp(self.ln2(x).to(dt))


class _ParallelCausalBlock(_ParallelBlock):
    """``models/decoder._CausalBlock``'s training forward (no KV cache) with
    its attention and MLP over the model devices."""

    def forward(self, x, cache=None, pos=None, key_valid=None):
        if cache is not None:
            raise ValueError("a tensor-parallel block has no KV cache")
        dt = self.attn.parts[0].cfg.dtype
        x = x + self.attn(self.ln1(x).to(dt), key_valid)
        return x + self.mlp(self.ln2(x).to(dt)), None


def _empty_on(device, make) -> nn.Module:
    """``make()`` built on the meta device, then allocated on ``device``
    (its values come from the whole weights)."""
    with torch.device("meta"):
        module = make()
    return module.to_empty(device=device)


def _parallel_block(block, cfg, devices):
    """(the tensor-parallel form of ``block`` over ``devices``, its whole
    weights' names -> the pieces that hold them)."""
    n = len(devices)
    heads, mlp = cfg.num_heads // n, cfg.mlp_dim // n
    dt = block.mlp_in.weight.dtype
    h = cfg.hidden_dim
    if isinstance(block, _Block):
        lin, act, cls = Linear, gelu, _ParallelBlock
        attn = [_empty_on(d, lambda: _Attention(cfg, dt, heads))
                for d in devices]
        names = {f"attn.{m}.{leaf}": (m, leaf)
                 for m in ("query", "key", "value", "out")
                 for leaf in ("weight", "bias")}
        row_bias = ("attn.out.bias", block.attn.out.bias)
    else:
        lin, act, cls = (_decoder.Dense, _decoder.gelu_tanh,
                         _ParallelCausalBlock)
        attn = [_empty_on(d, lambda: _CausalHeads(cfg, heads, dt))
                for d in devices]
        names = {f"{m}.{leaf}": (m, leaf) for m in ("qkv", "attn_out")
                 for leaf in ("weight", "bias")}
        row_bias = ("attn_out.bias", block.attn_out.bias)
    mlps = [_empty_on(d, lambda: _MLPPart(
        lin(h, mlp, dtype=dt), lin(mlp, h, bias=False, dtype=dt), act))
        for d in devices]
    new = cls(block.ln1, _Parallel(attn, row_bias[1]), block.ln2,
              _Parallel(mlps, block.mlp_out.bias))
    pieces = {}
    for name, (module, leaf) in names.items():
        if name != row_bias[0]:
            pieces[name] = [getattr(getattr(a, module), leaf) for a in attn]
    for module in ("mlp_in", "mlp_out"):
        pieces[f"{module}.weight"] = [getattr(p, module).weight
                                      for p in mlps]
    pieces["mlp_in.bias"] = [p.mlp_in.bias for p in mlps]
    pieces[row_bias[0]] = [new.attn.bias]
    pieces["mlp_out.bias"] = [new.mlp.bias]
    return new, pieces


def _piece_rule(name: str) -> tuple:
    """``split_rule`` for a tensor-parallel copy: the column layers' biases
    go with their columns (JAX replicates them; each device needs its
    heads' part, which is the same computation without the copies)."""
    if name.endswith(".bias"):
        dim, groups = split_rule(name[:-len("bias")] + "weight")
        if dim == 0:
            return dim, groups
    return split_rule(name)


def tensor_parallel(model: nn.Module, cfg, devices) -> tuple:
    """A copy of ``model`` on ``devices[0]`` whose transformer blocks run
    tensor-parallel over ``devices``, and its map from each of ``model``'s
    weight names to (pieces, dim, groups). The pieces are allocated, not
    filled: copy the whole weights in with ``_split``."""
    n = len(devices)
    if cfg.num_heads % n or cfg.mlp_dim % n:
        raise ValueError(f"tensor parallelism over model={n} needs "
                         f"num_heads ({cfg.num_heads}) and mlp_dim "
                         f"({cfg.mlp_dim}) to divide by {n}")
    copy_ = copy.deepcopy(model).to(devices[0])
    pieces = {}
    for list_name, blocks in list(copy_.named_modules()):
        if not isinstance(blocks, nn.ModuleList):
            continue
        for i, block in enumerate(blocks):
            if isinstance(block, (_Block, _decoder._CausalBlock)):
                blocks[i], local = _parallel_block(block, cfg, devices)
                pieces.update({f"{list_name}.{i}.{k}": v
                               for k, v in local.items()})
    own = dict(copy_.named_parameters())
    return copy_, {name: ((pieces[name], *_piece_rule(name))
                          if name in pieces else ([own[name]], None, 1))
                   for name, _ in model.named_parameters()}


# ---------------------------------------------------------------------------
# Losses and the optimizer
# ---------------------------------------------------------------------------

def info_nce_loss(q_emb, d_emb, temperature: float = 0.05):
    """Symmetric in-batch-negative InfoNCE. q_emb/d_emb [B, D] unit vecs."""
    logits = (q_emb.float() @ d_emb.float().T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss_q = torch.logsumexp(logits, dim=1) - logits[labels, labels]
    loss_d = torch.logsumexp(logits.T, dim=1) - logits[labels, labels]
    return 0.5 * (loss_q.mean() + loss_d.mean())


def sigmoid_binary_cross_entropy(logits, labels):
    """``optax.sigmoid_binary_cross_entropy``, per element."""
    labels = labels.to(logits.dtype)
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all the tensors together (on
    the first one's device)."""
    at = tensors[0].device
    return torch.sqrt(sum(torch.sum(t * t).to(at) for t in tensors))


def clip_by_global_norm(tensors, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm(max_norm)`` in place: each tensor becomes
    ``(t / norm) * max_norm`` where the global norm is ``max_norm`` or more,
    and stays as it is below. Returns the norm before clipping."""
    norm = global_norm(tensors)
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    div, mul = torch.where(keep, one, norm), torch.where(keep, one,
                                                         one * max_norm)
    by_device = {}
    for t in tensors:
        by_device.setdefault(t.device, []).append(t)
    for dev, ts in by_device.items():
        torch._foreach_div_(ts, div.to(dev))
        torch._foreach_mul_(ts, mul.to(dev))
    return norm


class AdamW:
    """``optax.adamw(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8 and weight
    decay 1e-4 on every parameter (biases, LayerNorms and embeddings too),
    optionally after ``optax.clip_by_global_norm(clip_norm)``:

        mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  t += 1
        u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p
        p = p + (-lr) * u

    A callable ``learning_rate`` is called with the count of updates
    already made (0 on the first step), as optax calls a schedule.
    """

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 clip_norm: float | None = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params: dict) -> dict:
        """The state of a fresh optimizer: the update count and both moments
        (zeros like each parameter)."""
        return {"count": 0,
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def clip_(self, grads: list):
        """``clip_by_global_norm(clip_norm)`` in place where ``clip_norm``
        is set; the global norm before clipping (a tensor), or None."""
        return (clip_by_global_norm(grads, self.clip_norm)
                if self.clip_norm is not None else None)

    @torch.no_grad()
    def update_(self, params: dict, grads: dict, state: dict,
                clip: bool = True):
        """One step in place on ``params`` (name -> tensor) from ``grads``
        (same names; clipped in place by ``clip_`` unless ``clip`` is
        False, for gradients clipped already) and ``state``. Returns the
        global norm before clipping (a tensor), or None without clipping."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        norm = self.clip_(g) if clip else None
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - b2))
        lr = self.lr(state["count"])
        state["count"] += 1
        count = np.float32(state["count"])
        bc1 = float(np.float32(1) - np.float32(b1) ** count)
        bc2 = float(np.float32(1) - np.float32(b2) ** count)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(p, u)
        return norm


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------

def _processes(mesh) -> tuple:
    """(processes on the mesh's ``dcn`` axis, this process's index)."""
    n = mesh.shape.get("dcn", 1)
    if n > 1:
        import torch.distributed as dist
        if not (dist.is_initialized() and dist.get_world_size() == n):
            raise ValueError(f"{mesh} spans {n} processes: initialise a "
                             f"torch.distributed group of {n} first")
    return n, mesh.process_index


def _all_gather_rows(local: torch.Tensor, n: int, rank: int):
    """Every process's rows in process order; this process's keep their
    graph (the others' are values: each process differentiates the same
    loss with respect to its own rows)."""
    import torch.distributed as dist
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local.detach().contiguous())
    parts[rank] = local
    return torch.cat(parts)


def _all_reduce_(grads: dict) -> None:
    """Sum ``grads`` (keyed (name, piece), as ``_flat``) over the processes
    in place: one all-reduce of the pieces at each model position, which
    lie on one device."""
    import torch.distributed as dist
    at = {}
    for key, g in grads.items():
        at.setdefault(key[1], []).append(g)
    for m in sorted(at):
        flat = torch.cat([g.reshape(-1) for g in at[m]])
        dist.all_reduce(flat)
        for g, part in zip(at[m], flat.split([g.numel() for g in at[m]])):
            g.copy_(part.view_as(g))


def _flat(pieces: dict) -> dict:
    """A copy's parameters keyed (weight name, piece index)."""
    return {(k, i): p for k, (params, _, _) in pieces.items()
            for i, p in enumerate(params)}


@torch.no_grad()
def _fill_(pieces: dict, state: dict) -> None:
    """Copy the whole tensors of ``state`` into a copy's ``pieces``."""
    for k, (params, dim, groups) in pieces.items():
        for p, w in zip(params, _split(state[k].detach(), dim, groups,
                                       len(params))):
            p.copy_(w)


class Trainer:
    """A model in its training form on the mesh and its AdamW, one copy for
    each data row: the model itself on a one-device row (the first row's is
    ``model``), a tensor-parallel copy where the row has several model
    devices (then ``model`` is the first row's). A copy's parameters are
    its pieces of the weights, each with its AdamW moments on its device;
    every copy takes the same step from the same summed gradients, so the
    copies stay equal. ``params`` (get and set) is the model's state dict,
    float32, joined from the first copy's pieces (or split into every
    copy's); ``opt_state`` (get and set) the optimizer's, whole tensors
    alike. A subclass gives ``_batch(*args)``, a step's arguments as
    (arrays split by rows over the data devices, arrays the loss takes
    whole); ``_rows(model, *block)``, the per-row outputs of one row block;
    ``_loss(rows, *whole)``, the loss and its auxiliaries over the gathered
    rows of the global batch; and ``_result(loss, aux)``, what
    ``train_step`` returns."""

    def __init__(self, make, mesh, learning_rate, seed: int = 0,
                 clip_norm: float | None = None):
        self.mesh = mesh
        self.rows = data_rows(mesh)
        self.processes = _processes(mesh)
        self.device = self.rows[0][0]
        whole = training_module(make, self.device, seed)
        self._shapes = {k: tuple(v.shape)
                        for k, v in whole.state_dict().items()}
        self._replicas = [self._copy(whole, row, j == 0)
                          for j, row in enumerate(self.rows)]
        self.model = self._replicas[0][0]
        self.tx = AdamW(learning_rate, clip_norm=clip_norm)
        self._opt = [self.tx.init(_flat(pieces))
                     for _, pieces in self._replicas]
        self.last_grad_norm = None

    def _copy(self, whole, row, first: bool) -> tuple:
        """(a data row's copy of ``whole``, its pieces: weight name ->
        (parameters, dim, groups))."""
        if len(row) > 1:
            module, pieces = tensor_parallel(whole, self.cfg, row)
            _fill_(pieces, dict(whole.named_parameters()))
            return module, pieces
        module = whole if first else copy.deepcopy(whole).to(row[0])
        return module, {k: ([p], None, 1)
                        for k, p in module.named_parameters()}

    def _whole(self, tensors: dict) -> dict:
        """Whole tensors, by weight name, of the first copy's ``tensors``
        keyed as ``_flat``."""
        out = {}
        for k, (params, dim, groups) in self._replicas[0][1].items():
            w = _join([tensors[(k, i)].detach() for i in range(len(params))],
                      dim, groups)
            out[k] = w.clone() if dim is None else w
        return out

    def _check(self, state: dict) -> None:
        bad = sorted(set(state) ^ set(self._shapes)) or [
            k for k, shape in self._shapes.items()
            if tuple(state[k].shape) != shape]
        if bad:
            raise RuntimeError(f"the state dict does not fit the model at "
                               f"{bad[:5]}")

    @property
    def params(self) -> dict:
        """A copy of the model's state dict (float32, on the first
        device)."""
        return self._whole(_flat(self._replicas[0][1]))

    @params.setter
    def params(self, state: dict) -> None:
        self._check(state)
        for _, pieces in self._replicas:
            _fill_(pieces, state)

    @property
    def opt_state(self) -> dict:
        """A copy of the optimizer state: ``count``, ``mu`` and ``nu``."""
        opt = self._opt[0]
        return {"count": opt["count"],
                **{m: self._whole(opt[m]) for m in ("mu", "nu")}}

    @opt_state.setter
    @torch.no_grad()
    def opt_state(self, state: dict) -> None:
        for m in ("mu", "nu"):
            self._check(state[m])
        for (_, pieces), opt in zip(self._replicas, self._opt):
            opt["count"] = int(state["count"])
            for m in ("mu", "nu"):
                for k, (params, dim, groups) in pieces.items():
                    for i, w in enumerate(_split(state[m][k], dim, groups,
                                                 len(params))):
                        opt[m][(k, i)].copy_(w)

    def _grads(self) -> dict:
        """The last step's gradients, summed over the data rows (and
        clipped where ``clip_norm`` is set), whole, by weight name."""
        return self._whole({key: p.grad for key, p in
                            _flat(self._replicas[0][1]).items()})

    @torch.no_grad()
    def _reduce_grads(self) -> list:
        """The data axis's all-reduce: the first copy's gradients become
        the sum of every copy's, in row order, then over the processes;
        they are clipped there (``clip_norm``) and every other copy takes
        them. Returns each copy's gradients keyed as ``_flat``."""
        flats = [_flat(pieces) for _, pieces in self._replicas]
        first = {}
        for key, p in flats[0].items():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            for other in flats[1:]:
                g = other[key].grad
                if g is not None:
                    p.grad += g.to(p.device)
            first[key] = p.grad
        if self.processes[0] > 1:
            _all_reduce_(first)
        self.last_grad_norm = self.tx.clip_(list(first.values()))
        out = [first]
        for other in flats[1:]:
            for key, p in other.items():
                p.grad = first[key].to(p.device, copy=True)
            out.append({key: p.grad for key, p in other.items()})
        return out

    def _step(self, split, whole=()):
        """One training step: ``split`` arrays are split by rows over the
        data rows of every process, ``whole`` ones go whole to the loss.
        Returns the loss and its auxiliaries as tensors."""
        n_proc, rank = self.processes
        n = n_proc * len(self.rows)
        b = len(split[0])
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} data "
                             "devices")
        rows = b // n
        for replica, _ in self._replicas:
            replica.zero_grad(set_to_none=True)
        outs = []
        for j, (row, (replica, _)) in enumerate(zip(self.rows,
                                                    self._replicas)):
            at = (rank * len(self.rows) + j) * rows
            block = [torch.as_tensor(a[at:at + rows]).to(row[0])
                     for a in split]
            outs.append([t.to(self.device)
                         for t in self._rows(replica, *block)])
        gathered = [torch.cat(parts) for parts in zip(*outs)]
        if n_proc > 1:
            gathered = [_all_gather_rows(t, n_proc, rank) for t in gathered]
        loss, aux = self._loss(gathered, *[torch.as_tensor(a).to(self.device)
                                           for a in whole])
        loss.backward()
        for (_, pieces), opt, grads in zip(self._replicas, self._opt,
                                           self._reduce_grads()):
            self.tx.update_(_flat(pieces), grads, opt, clip=False)
        return loss.detach(), aux

    def _result(self, loss, aux):
        return float(loss)

    def train_step(self, *args):
        """One step on a batch (numpy arrays or tensors); returns the loss
        of the weights it started from, as a Python float."""
        return self._result(*self._step(*self._batch(*args)))

    @torch.no_grad()
    def batch_loss(self, *args):
        """What ``train_step`` would return for this batch at the current
        weights, without a step (on the first data device)."""
        split, whole = self._batch(*args)
        on = lambda arrays: [torch.as_tensor(a).to(self.device)  # noqa
                             for a in arrays]
        rows = self._rows(self.model, *on(split))
        return self._result(*self._loss(list(rows), *on(whole)))


class BiEncoderTrainer(Trainer):
    """Contrastive trainer for the embedding model."""

    def __init__(self, cfg: TransformerConfig, mesh,
                 learning_rate=1e-4, temperature: float = 0.05,
                 seed: int = 0):
        self.cfg = cfg
        self.temperature = temperature
        super().__init__(lambda: BiEncoder(cfg, torch.float32), mesh,
                         learning_rate, seed)

    def _rows(self, model, q_ids, q_mask, d_ids, d_mask):
        return model(q_ids.long(), q_mask), model(d_ids.long(), d_mask)

    def _batch(self, q_ids, q_mask, d_ids, d_mask):
        return (q_ids, q_mask, d_ids, d_mask), ()

    def _loss(self, rows):
        return info_nce_loss(rows[0], rows[1], self.temperature), ()


class DecoderTrainer(Trainer):
    """Causal-LM trainer (next-token cross-entropy over non-PAD targets)."""

    def __init__(self, cfg, mesh, learning_rate=3e-4, seed: int = 0):
        from optimized_rag_tpu_torch.models.decoder import PAD, DecoderLM
        self.cfg = cfg
        self._pad = PAD
        super().__init__(lambda: DecoderLM(cfg, torch.float32), mesh,
                         learning_rate, seed)

    def _rows(self, model, ids):
        logits, _, _ = model(ids.long())
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = ids[:, 1:].long()
        return (torch.gather(logp, -1, tgt[..., None])[..., 0],)

    def _batch(self, ids):
        return (ids,), (ids,)

    def _loss(self, rows, ids):
        mask = (ids[:, 1:] != self._pad).float()
        return -(rows[0] * mask).sum() / torch.clamp_min(mask.sum(), 1.0), ()


class CrossEncoderTrainer(Trainer):
    """Pointwise (query, document) relevance trainer."""

    def __init__(self, cfg: TransformerConfig, mesh, learning_rate=1e-4,
                 seed: int = 0):
        self.cfg = cfg
        super().__init__(lambda: CrossEncoder(cfg, torch.float32), mesh,
                         learning_rate, seed)

    def _rows(self, model, ids, mask, types):
        return (model(ids.long(), mask, types.long()),)

    def _batch(self, ids, mask, types, labels):
        return (ids, mask, types), (labels,)

    def _loss(self, rows, labels):
        return sigmoid_binary_cross_entropy(rows[0], labels).mean(), ()
