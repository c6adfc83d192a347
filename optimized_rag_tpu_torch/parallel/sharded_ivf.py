"""Mesh-sharded IVF: cluster-partitioned storage, a probe per shard, and a
gather and merge of the winners.

Held against ``optimized_rag_tpu/parallel/sharded_ivf.py`` (:42-204).
The composition of the single-device IVF and the sharded top-k:

  * centroids come from spherical k-means (``ops/kmeans.py``) on the mesh's
    first device, and WHOLE clusters go to shards (largest first onto the
    least-loaded shard), so every probe window is shard-local;
  * each shard runs the single-device probe (``index/ivf._ivf_search``)
    over its own rows with the centroid scores masked to the clusters it
    owns, so the union of the shards' probes covers the global top-nprobe
    plan;
  * the [B, k] winners of every shard are gathered and merged as in
    ``parallel/sharded_topk.py`` (ties to the lower shard).

A persistent storage-row -> external-id array keeps a search's host work
O(B * k). The build's k-means draws its init from the port's generator
(``ops/kmeans._init_centroids``), not the reference's Threefry.
"""

from __future__ import annotations

import numpy as np
import torch

from optimized_rag_tpu_torch.index.ivf import _ivf_search, _round_up
from optimized_rag_tpu_torch.ops.kmeans import (
    balanced_assign, kmeans_assign, kmeans_fit)
from optimized_rag_tpu_torch.ops.similarity import normalize
from optimized_rag_tpu_torch.ops.topk_kernels import NEG_INF
from optimized_rag_tpu_torch.parallel.mesh import Mesh, Sharding
from optimized_rag_tpu_torch.parallel.sharded_topk import merge_winners


def partition_clusters(counts: np.ndarray, ndev: int) -> np.ndarray:
    """Greedy balanced partition: largest cluster first onto the
    least-loaded shard. Returns shard id per cluster."""
    shard_of = np.zeros(len(counts), np.int32)
    load = np.zeros(ndev, np.int64)
    for c in np.argsort(-counts, kind="stable"):
        s = int(np.argmin(load))
        shard_of[c] = s
        load[s] += int(counts[c])
    return shard_of


def _sharded_ivf_search(q, shards, k: int, nprobe: int, window: int,
                        npad: int, across_processes: bool):
    """q [B, D] unit float32; ``shards`` this process's (shard index,
    centroids, rows [npad, D], starts [C], counts [C], owned [C]). Returns
    (scores [B, k], rows [B, k]) indexing the stacked [ndev*npad] storage,
    -1 where missing."""
    scores, rows = [], []
    for j, cent, emb, starts, counts, owned in shards:
        s, slots = _ivf_search(q.to(emb.device, non_blocking=True), cent,
                               emb, starts, counts, k=k, nprobe=nprobe,
                               window=window, owned=owned)
        scores.append(s)
        rows.append(torch.where(slots >= 0, slots + j * npad, -1))
    return merge_winners(scores, rows, k, across_processes)


class ShardedIVFIndex:
    """Frozen cluster-pruned index partitioned over the mesh's ``axis``.

    Like IVFIndex, built once over the current corpus; incremental adds
    belong in the exact index until the next rebuild (the retriever unions
    both result sets).
    """

    def __init__(self, mesh: Mesh, num_clusters: int = 1024,
                 nprobe: int = 64, kmeans_iters: int = 8, tile: int = 1024,
                 seed: int = 0, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.shape[axis]
        self.num_clusters = num_clusters
        self.nprobe = nprobe
        self.kmeans_iters = kmeans_iters
        self.tile = tile
        self.seed = seed
        self.size = 0
        self._sharding = Sharding(mesh, (axis,))
        self._local = self._sharding.local_shards()

    def build(self, embeddings, ids=None, storage_dtype=torch.float32,
              train_sample: int = 1 << 21, balanced: bool = False,
              cap_factor: float = 1.15) -> None:
        """Train centroids on the first device, deal clusters to shards and
        lay each shard's rows out cluster-sorted on its device.
        ``embeddings`` [N, D]: numpy or a tensor on any device."""
        dev = self._local[0][1]
        x = torch.as_tensor(embeddings, device=dev)
        emb = normalize(x.float() if x.dtype == torch.float64 else x
                        ).to(storage_dtype)
        del x, embeddings      # a caller that passed its last reference frees it
        n, d = emb.shape
        c = min(self.num_clusters, max(self.ndev, n // 4))
        centroids, _ = kmeans_fit(emb[: min(n, train_sample)].float(), c,
                                  iters=self.kmeans_iters, seed=self.seed)
        if balanced:  # equal-size clusters: smaller probe windows and a
            # naturally balanced partition (index/ivf.py)
            cap = max(1, int(np.ceil(n / c * cap_factor)))
            assign = torch.from_numpy(balanced_assign(
                emb, centroids, cap, chunk=1 << 16)).to(dev)
        else:
            assign = kmeans_assign(emb, centroids, chunk=1 << 20)[0]
        assign = assign.long()
        counts_c = torch.bincount(assign, minlength=c).cpu().numpy()
        shard_of = partition_clusters(counts_c, self.ndev)

        # Shard-major, cluster-minor row layout (np.lexsort((assign,
        # shard)) of the reference, as one stable sort on the device).
        shard_of_t = torch.from_numpy(shard_of).to(dev).long()
        order = torch.argsort(shard_of_t[assign] * c + assign, stable=True)
        rows_per_shard = np.bincount(shard_of, weights=counts_c,
                                     minlength=self.ndev).astype(np.int64)
        del assign
        self._window = max(self.tile,
                           _round_up(int(counts_c.max() or 1), self.tile))
        npad = _round_up(int(rows_per_shard.max() or 1), self.tile) \
            + self._window
        self._npad = npad
        offsets = np.concatenate([[0], np.cumsum(rows_per_shard)])

        # Per-shard cluster tables: local start offsets; zero counts for
        # clusters a shard does not own (a stray probe matches nothing).
        self._shards = []
        for s, sdev in self._local:
            mine = shard_of == s
            local_counts = np.where(mine, counts_c, 0)
            starts = np.concatenate([[0], np.cumsum(local_counts)[:-1]])
            block = torch.zeros(npad, d, dtype=storage_dtype, device=sdev)
            mine_rows = order[offsets[s]:offsets[s + 1]]
            if sdev == dev:
                torch.index_select(emb, 0, mine_rows,
                                   out=block[:rows_per_shard[s]])
            else:
                block[:rows_per_shard[s]] = emb[mine_rows].to(sdev)
            self._shards.append((
                s, centroids.to(sdev), block,
                torch.from_numpy(starts.astype(np.int32)).to(sdev),
                torch.from_numpy(local_counts.astype(np.int32)).to(sdev),
                torch.from_numpy(mine & (counts_c > 0)).to(sdev)))
        del emb
        self._centroids = centroids

        # Storage-row -> external-id map (O(B*k) search-side mapping).
        order = order.cpu().numpy()
        src_ids = (np.arange(n, dtype=np.int64) if ids is None
                   else np.asarray(ids, np.int64))
        dst = np.concatenate([
            s * npad + np.arange(rows_per_shard[s], dtype=np.int64)
            for s in range(self.ndev)])
        self._row_to_ext = np.full(self.ndev * npad, -1, np.int64)
        self._row_to_ext[dst] = src_ids[order]
        self.size = n
        self.num_clusters_built = c

    def search(self, queries, k: int, nprobe: int | None = None):
        """Returns (scores [B,k] np.float32, ids [B,k] np.int64; -1 =
        missing)."""
        if not self.size:
            raise RuntimeError("build() first")
        dev = self._local[0][1]
        q = torch.atleast_2d(torch.as_tensor(queries, device=dev))
        q = normalize(q.float())
        nprobe = min(nprobe or self.nprobe, self.num_clusters_built)
        kk = min(k, self.size)
        scores, rows = _sharded_ivf_search(
            q, self._shards, kk, nprobe, self._window, self._npad,
            len(self._local) < self._sharding.num_shards)
        scores = scores.cpu().numpy()
        rows = rows.cpu().numpy()
        ids = self._row_to_ext[np.clip(rows, 0, len(self._row_to_ext) - 1)]
        miss = (rows < 0) | (scores < NEG_INF / 2)
        out_s = np.where(miss, -np.inf, scores).astype(np.float32)
        out_i = np.where(miss, -1, ids)
        if kk < k:
            pad = k - kk
            out_s = np.pad(out_s, ((0, 0), (0, pad)),
                           constant_values=-np.inf)
            out_i = np.pad(out_i, ((0, 0), (0, pad)), constant_values=-1)
        return out_s, out_i
