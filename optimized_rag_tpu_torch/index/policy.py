"""Index selection policy: Dense / IVF / sharded by scale and devices.

Held against ``optimized_rag_tpu/index/policy.py``. ``select_index_kind``
is the reference's pure policy, copied: exact brute force on one device up
to ``ivf_min_size`` rows, IVF past it, and on several devices rows (or
clusters) sharded with an all-gather merge. The agent consults it at
startup and again after ingestion grows the corpus.

``build_index_for`` builds the port's ``DenseIndex`` or ``IVFIndex`` on
``device``. The sharded indexes are not ported yet: they raise
``NotImplementedError`` naming the ``ROADMAP.md`` Queue 1 item that ports
them.
"""

from __future__ import annotations

from typing import Optional

_NOT_PORTED = {
    "sharded_dense": "sharded indexes are not ported yet (ROADMAP.md "
                     "Queue 1 item 8)",
    "sharded_ivf": "sharded indexes are not ported yet (ROADMAP.md "
                   "Queue 1 item 8)",
}


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
    if kind in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[kind])
    raise ValueError(f"unknown index kind {kind!r}")


def mesh_or_none(settings) -> Optional[object]:
    """None when settings ask for at most one-way data parallelism;
    several devices are not ported yet."""
    if settings.mesh.data_parallel <= 1:
        return None
    raise NotImplementedError(
        f"data_parallel={settings.mesh.data_parallel}: multi-device "
        "meshes are not ported yet (ROADMAP.md Queue 1 item 8)")
