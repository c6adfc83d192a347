"""Index selection policy: Dense / IVF / sharded by scale and devices.

Held against ``optimized_rag_tpu/index/policy.py``. ``select_index_kind``
is the reference's pure policy, copied: exact brute force on one device up
to ``ivf_min_size`` rows, IVF past it, and on several devices rows (or
clusters) sharded with an all-gather merge. The agent consults it at
startup and again after ingestion grows the corpus.

``build_index_for`` builds the port's ``DenseIndex`` or ``IVFIndex`` on
``device``, and the sharded indexes over a mesh (``parallel/``), whose
devices ``mesh_or_none`` lays out.
"""

from __future__ import annotations

from typing import Optional


def select_index_kind(corpus_size: int, n_devices: int,
                      ivf_min_size: int = 16_000_000,
                      shard_min_size: int = 250_000) -> str:
    """Returns one of "dense", "ivf", "sharded_dense", "sharded_ivf".

    * single device: exact brute force until ``ivf_min_size``, IVF past it
    * multi device: small corpora stay dense on one device (collectives
      cost more than they save below ``shard_min_size``); larger ones
      shard rows; past ``ivf_min_size`` for the whole corpus, shard
      clusters
    """
    if n_devices <= 1:
        return "dense" if corpus_size < ivf_min_size else "ivf"
    if corpus_size < shard_min_size:
        return "dense"
    return "sharded_dense" if corpus_size < ivf_min_size else "sharded_ivf"


def build_index_for(kind: str, dim: int, settings, mesh=None,
                    capacity_block: int = 65536, tile: int = 1024,
                    device="cuda"):
    """Construct an (empty or to-be-built) index of the selected kind on
    ``device``."""
    if kind == "dense":
        from optimized_rag_tpu_torch.index.dense import DenseIndex
        return DenseIndex(dim=dim, capacity_block=capacity_block, tile=tile,
                          device=device)
    if kind == "ivf":
        from optimized_rag_tpu_torch.index.ivf import IVFIndex
        return IVFIndex(num_clusters=settings.ivf.num_clusters,
                        nprobe=settings.ivf.nprobe,
                        kmeans_iters=settings.ivf.kmeans_iters, tile=tile,
                        device=device)
    if kind not in ("sharded_dense", "sharded_ivf"):
        raise ValueError(f"unknown index kind {kind!r}")
    if mesh is None:
        raise ValueError(f"{kind} needs a mesh")
    if kind == "sharded_dense":
        from optimized_rag_tpu_torch.parallel.sharded_topk import (
            ShardedDenseIndex)
        return ShardedDenseIndex(dim=dim, mesh=mesh,
                                 capacity_block=capacity_block, tile=tile)
    from optimized_rag_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex
    return ShardedIVFIndex(mesh, num_clusters=settings.ivf.num_clusters,
                           nprobe=settings.ivf.nprobe,
                           kmeans_iters=settings.ivf.kmeans_iters, tile=tile)


def mesh_or_none(settings, device="cuda", devices=None) -> Optional[object]:
    """The configured (data, model) mesh when settings ask for more than
    one-way data parallelism, else None (everything on one device).

    ``devices`` lays the mesh out; by default every CUDA device (too few
    raise), or on the CPU as many logical CPU devices as the mesh needs.
    """
    if settings.mesh.data_parallel <= 1:
        return None
    import torch

    from optimized_rag_tpu_torch.device import resolve_device
    from optimized_rag_tpu_torch.parallel.mesh import make_mesh
    m = settings.mesh
    if devices is None and resolve_device(device).type == "cpu":
        devices = [torch.device("cpu")] * (m.data_parallel * m.model_parallel)
    return make_mesh(data=m.data_parallel, model=m.model_parallel,
                     devices=devices)
