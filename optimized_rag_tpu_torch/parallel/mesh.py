"""Mesh construction and row placement.

Held against ``optimized_rag_tpu/parallel/mesh.py`` (:20-78). The JAX
package is single-controller: one process drives every local device, and
``jax.distributed`` adds hosts. The port keeps that model. A ``Mesh`` is an
array of ``torch.device``s with axis names; one process drives every device
of its own host, and ``torch.distributed`` (gloo on the CPU, NCCL across
GPUs) adds hosts on the ``dcn`` axis.

  dcn    — (multi-host only) one position per process; only the corpus
           and its [B, k] winners cross it
  data   — corpus shards
  model  — tensor parallelism for training (models/training.py splits
           the training form's attention and MLP over it)

A row-sharded tensor is one row block per position of its axes, each on
its own device: the device at model index 0, and on this process's own
``dcn`` row where ``dcn`` is not one of the axes. Nothing copies the whole
tensor to one device. A device list may name one device more than once:
that lays several logical devices on one card or on the CPU (the tests'
stand-in for XLA's virtual CPU devices).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from optimized_rag_tpu_torch.device import resolve_device


class Mesh:
    """Devices in a named grid, like ``jax.sharding.Mesh``.

    ``devices`` is an object array of ``torch.device``; ``process_ids``
    (same shape) names the process that drives each device, and
    ``process_index`` is this process's.
    """

    def __init__(self, devices: np.ndarray, axis_names, process_ids=None,
                 process_index: int = 0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        self.process_ids = (np.zeros(devices.shape, np.int64)
                            if process_ids is None else process_ids)
        self.process_index = process_index

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _device_grid(devices, shape) -> np.ndarray:
    grid = np.empty(len(devices), object)
    grid[:] = devices
    return grid.reshape(shape)


def _local_devices(devices):
    """The devices asked for, or every CUDA device; never the CPU unless
    named."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """Build a (data, model) mesh. ``data=None`` uses every device;
    ``devices`` defaults to every CUDA device and raises without one."""
    devices = _local_devices(devices)
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices do not split into model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} > {n} devices")
    return Mesh(_device_grid(devices[:data * model], (data, model)),
                ("data", "model"))


def _process_group():
    """(world size, rank) of the initialised process group, else (1, 0)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_multihost_mesh(model: int = 1, data_per_host: int | None = None,
                        devices=None) -> Mesh:
    """(dcn, data, model) mesh: ``dcn`` spans the processes of the
    initialised ``torch.distributed`` group (one per host), ``data`` and
    ``model`` each process's own devices (``devices``, default every CUDA
    device). Every process names its devices alike. Outside a process
    group it is a one-host mesh, so the same code path runs everywhere."""
    n_hosts, rank = _process_group()
    local = _local_devices(devices)
    if data_per_host is None:
        if len(local) % model:
            raise ValueError(f"{len(local)} devices do not split into "
                             f"model={model}")
        data_per_host = len(local) // model
    per_host = data_per_host * model
    if per_host > len(local):
        raise ValueError(f"{data_per_host}x{model} > {len(local)} local "
                         "devices")
    shape = (n_hosts, data_per_host, model)
    procs = np.repeat(np.arange(n_hosts), per_host).reshape(shape)
    return Mesh(_device_grid(local[:per_host] * n_hosts, shape),
                ("dcn", "data", "model"), procs, rank)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Rows split over ``axes`` (in row-major order of those axes); the
    port's ``NamedSharding(mesh, P(axes, None))``. ``axes=()`` is one block:
    each process keeps one copy, on its first device."""
    mesh: Mesh
    axes: tuple

    @property
    def num_shards(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.axes]))

    def local_shards(self) -> list[tuple[int, torch.device]]:
        """(shard index, device) of every shard this process holds, in
        shard order."""
        mesh = self.mesh
        fixed = {a: (mesh.process_index if a == "dcn" else 0)
                 for a in mesh.axis_names if a not in self.axes}
        out = []
        for j, pos in enumerate(itertools.product(
                *(range(mesh.shape[a]) for a in self.axes))):
            at = dict(zip(self.axes, pos), **fixed)
            where = tuple(at[a] for a in mesh.axis_names)
            if mesh.process_ids[where] == mesh.process_index:
                out.append((j, mesh.devices[where]))
        return out


def corpus_sharding(mesh: Mesh) -> Sharding:
    """Corpus rows sharded across the data axis."""
    return Sharding(mesh, ("data",))


def dcn_corpus_sharding(mesh: Mesh) -> Sharding:
    """Corpus rows sharded over both dcn and data: each host holds
    N/hosts rows, each device N/(hosts*data)."""
    return Sharding(mesh, ("dcn", "data"))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_corpus(mesh: Mesh, corpus, sharding: Sharding | None = None
                 ) -> list[torch.Tensor]:
    """This process's row blocks of ``corpus`` [N, D] (numpy or a tensor on
    any device; N a multiple of the shard count), each on its device, in
    shard order."""
    sharding = sharding or corpus_sharding(mesh)
    x = torch.as_tensor(corpus)
    n, ndev = x.shape[0], sharding.num_shards
    if n % ndev:
        raise ValueError(f"{n} rows do not split into {ndev} shards")
    rows = n // ndev
    return [x[j * rows:(j + 1) * rows].to(dev)
            for j, dev in sharding.local_shards()]
