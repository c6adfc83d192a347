"""Training for the retrieval models and the decoder LM on a device mesh.

Held against ``optimized_rag_tpu/models/training.py`` (:35-242). The
objectives are the JAX package's: symmetric InfoNCE over in-batch negatives
for the bi-encoder, pointwise sigmoid cross-entropy for the cross-encoder,
next-token cross-entropy for the decoder LM, each minimised by AdamW as
``optax.adamw`` computes it.

The JAX trainers ``jit`` one step with sharding annotations; the sharding
changes where the work runs, not what is computed. Here the ``data`` axis
of the port's ``Mesh`` is data parallelism in one process: the batch is
split in equal row blocks, one per data device; each device runs forward
and backward on its copy of the weights; the per-row outputs (the
bi-encoder's embeddings, the tokens' log-probs) meet on the first device
before the loss, so the loss is the one-device loss over the global batch
(InfoNCE keeps every in-batch negative); the gradients are summed onto the
first device's weights, which take the step and are copied back out. A
device list that names one device several times runs the same code with
one copy of the weights. Tensor parallelism over ``model`` is not ported:
a mesh with ``model > 1``, or a ``dcn`` axis above 1, raises
``NotImplementedError``. ``param_pspec`` keeps the JAX package's layout
rule for it.

Weights are float32 master weights (``param_dtype=torch.float32``), cast to
``cfg.dtype`` at each use as Flax casts them, and start from Flax's
initialisers (``models/encoder.flax_init_``) drawn from a
``torch.Generator`` seeded with ``seed``; ``jax.random``'s stream cannot be
matched, so set ``params`` to start from given weights. TF32 stays off.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

from optimized_rag_tpu_torch.models.encoder import (
    BiEncoder, CrossEncoder, TransformerConfig, training_module)

TENSOR_PARALLEL_ITEM = "ROADMAP.md Queue 1 item 11"


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


def data_devices(mesh) -> list[torch.device]:
    """The mesh's data devices in order, one per row block. Raises
    ``NotImplementedError`` for a ``model`` or ``dcn`` axis above 1."""
    shape = mesh.shape
    if shape.get("model", 1) > 1 or shape.get("dcn", 1) > 1:
        raise NotImplementedError(
            f"training on {mesh}: tensor parallelism over the model axis "
            f"and training across hosts are not ported ({TENSOR_PARALLEL_ITEM})")
    return [torch.device(d) for d in mesh.devices.reshape(-1)]


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
    """``optax.global_norm``: the L2 norm of all the tensors together."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(tensors, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm(max_norm)`` in place: each tensor becomes
    ``(t / norm) * max_norm`` where the global norm is ``max_norm`` or more,
    and stays as it is below. Returns the norm before clipping."""
    norm = global_norm(tensors)
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(tensors, torch.where(keep, one, norm))
    torch._foreach_mul_(tensors, torch.where(keep, one, one * max_norm))
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

    @torch.no_grad()
    def update_(self, params: dict, grads: dict, state: dict):
        """One step in place on ``params`` (name -> tensor) from ``grads``
        (same names; clipped in place where ``clip_norm`` is set) and
        ``state``. Returns the global norm before clipping (a tensor), or
        None without clipping."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        norm = (clip_by_global_norm(g, self.clip_norm)
                if self.clip_norm is not None else None)
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

class Trainer:
    """A model in its training form on the mesh's data devices and its
    AdamW. ``params`` (get and set) is the model's state dict, float32;
    ``opt_state`` (get and set) the optimizer's. A subclass gives
    ``_batch(*args)``, a step's arguments as (arrays split by rows over the
    data devices, arrays the loss takes whole); ``_rows(model, *block)``,
    the per-row outputs of one row block; ``_loss(rows, *whole)``, the loss
    and its auxiliaries over the gathered rows of the global batch; and
    ``_result(loss, aux)``, what ``train_step`` returns."""

    def __init__(self, make, mesh, learning_rate, seed: int = 0,
                 clip_norm: float | None = None):
        self.mesh = mesh
        self.devices = data_devices(mesh)
        self.device = self.devices[0]
        self.model = training_module(make, self.device, seed)
        self._replicas = {self.device: self.model}
        for dev in self.devices:
            if dev not in self._replicas:
                self._replicas[dev] = copy.deepcopy(self.model).to(dev)
        self.tx = AdamW(learning_rate, clip_norm=clip_norm)
        self._opt = self.tx.init(self._named())
        self.last_grad_norm = None

    def _named(self) -> dict:
        return dict(self.model.named_parameters())

    @property
    def params(self) -> dict:
        """A copy of the model's state dict (float32, on its device)."""
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    @params.setter
    def params(self, state: dict) -> None:
        self.model.load_state_dict(state)
        self._sync()

    @property
    def opt_state(self) -> dict:
        """A copy of the optimizer state: ``count``, ``mu`` and ``nu``."""
        return {"count": self._opt["count"],
                **{m: {k: v.clone() for k, v in self._opt[m].items()}
                   for m in ("mu", "nu")}}

    @opt_state.setter
    def opt_state(self, state: dict) -> None:
        self._opt["count"] = int(state["count"])
        for m in ("mu", "nu"):
            for k, v in self._opt[m].items():
                v.copy_(state[m][k])

    @torch.no_grad()
    def _sync(self) -> None:
        """Copy the first device's weights to the other devices' copies."""
        for dev, replica in self._replicas.items():
            if replica is not self.model:
                for dst, src in zip(replica.parameters(),
                                    self.model.parameters()):
                    dst.copy_(src)

    def _grads(self) -> dict:
        """The gradients of every copy, summed onto the first device."""
        grads = {k: p.grad for k, p in self.model.named_parameters()}
        for dev, replica in self._replicas.items():
            if replica is self.model:
                continue
            for k, p in replica.named_parameters():
                if p.grad is not None:
                    g = p.grad.to(self.device)
                    grads[k] = g if grads[k] is None else grads[k] + g
        return {k: (torch.zeros_like(p) if grads[k] is None else grads[k])
                for k, p in self.model.named_parameters()}

    def _step(self, split, whole=()):
        """One training step: ``split`` arrays are split by rows over the
        data devices, ``whole`` ones go whole to the loss. Returns the loss
        and its auxiliaries as tensors."""
        n = len(self.devices)
        b = len(split[0])
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} data "
                             "devices")
        rows = b // n
        for replica in self._replicas.values():
            replica.zero_grad(set_to_none=True)
        outs = []
        for j, dev in enumerate(self.devices):
            block = [torch.as_tensor(a[j * rows:(j + 1) * rows]).to(dev)
                     for a in split]
            outs.append([t.to(self.device)
                         for t in self._rows(self._replicas[dev], *block)])
        gathered = [torch.cat(parts) for parts in zip(*outs)]
        loss, aux = self._loss(gathered, *[torch.as_tensor(a).to(self.device)
                                           for a in whole])
        loss.backward()
        self.last_grad_norm = self.tx.update_(self._named(), self._grads(),
                                              self._opt)
        self._sync()
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
