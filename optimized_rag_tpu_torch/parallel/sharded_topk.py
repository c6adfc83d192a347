"""Sharded dense top-k: a top-k per shard, then a gather and merge of the
winners.

Held against ``optimized_rag_tpu/parallel/sharded_topk.py`` (:26-240).
The corpus lives as one row block per shard, each on its device
(``parallel/mesh.py``). A search copies the queries to every shard's
device, runs the single-device search over that shard (K6 for
``impl="kernel"``), offsets the ids by the shard's first row, gathers the
[B, k] winners in shard order onto the first device and merges them. The
gathered volume is O(shards * B * k), whatever N is.

The merge is a stable top-k over the winners in shard order, so a tie goes
to the lower shard, as ``lax.top_k`` over the all-gathered winners gives
it. Shards of one process run one after another in a Python loop; their
sizes are host ints, so no shard waits on the host before its launch.
Across processes (an axis that includes ``dcn``) the process-local winners
are concatenated in shard order, then ``torch.distributed.all_gather``
collects them in rank order: the order of JAX's tiled all-gather.
"""

from __future__ import annotations

import numpy as np
import torch

from optimized_rag_tpu_torch.ops.similarity import normalize
from optimized_rag_tpu_torch.ops.topk import (
    _topk, chunked_topk, exact_topk, tiled_topk, topk_verified)
from optimized_rag_tpu_torch.ops.topk_kernels import NEG_INF
from optimized_rag_tpu_torch.parallel.mesh import Mesh, Sharding


def _shard_search(q, shard, k: int, size: int, impl: str, tile: int,
                 chunk: int):
    """The single-device top-k of one shard, routed as the reference
    routes it (``sharded_topk.py:55-68``)."""
    if impl == "kernel":
        if shard.shape[0] // tile >= 8 * k:
            # Extraction-bound shard: two winners a tile, and the tau-bound
            # rescan keeps the shard's answer exact.
            return topk_verified(q, shard, k, size=size, tile=tile, tile_k=2)
        return tiled_topk(q, shard, k, size=size, tile=tile)
    if impl == "chunked":
        return chunked_topk(q, shard, k, size=size, chunk=chunk)
    return exact_topk(q, shard, k, size=size)


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    """``x`` [B, m] of every process, concatenated in rank order along
    dim 1 (gloo gathers through the host)."""
    import torch.distributed as dist
    src = x.cpu() if dist.get_backend() == "gloo" else x
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src.contiguous())
    return torch.cat(parts, dim=1).to(x.device)


def merge_winners(scores, ids, k: int, across_processes: bool):
    """Top-k of per-shard winners (lists of [B, kk], shard order), gathered
    onto the first shard's device; ties to the lower shard."""
    dev = scores[0].device
    gs = torch.cat([s.to(dev) for s in scores], dim=1)
    gi = torch.cat([i.to(dev) for i in ids], dim=1)
    if across_processes:
        gs, gi = _all_gather(gs), _all_gather(gi)
    top_s, pos = _topk(gs, k)
    return top_s, torch.gather(gi, 1, pos)


def sharded_topk(queries: torch.Tensor, corpus: list[torch.Tensor], k: int,
                 *, mesh: Mesh, sizes, axis="data", impl: str = "auto",
                 tile: int = 1024, chunk: int = 65536):
    """Top-k over a row-sharded corpus.

    ``corpus`` is this process's row blocks in shard order
    (``mesh.shard_corpus``), all of one padded length; ``axis`` a mesh
    axis name, or a tuple like ("dcn", "data"); ``sizes`` the live rows of
    every shard (host ints). ``impl``: "kernel" (the reference's
    "pallas"), "chunked", or "auto" (exact). Returns (scores [B, k],
    global ids [B, k]) on the first shard's device.
    """
    sharding = Sharding(mesh, tuple(axis) if isinstance(axis, (tuple, list))
                        else (axis,))
    local = sharding.local_shards()
    if len(local) != len(corpus):
        raise ValueError(f"{len(corpus)} blocks for {len(local)} local "
                         "shards")
    shard_rows = corpus[0].shape[0]
    kk = min(k, shard_rows)
    scores, ids = [], []
    for (j, _), shard in zip(local, corpus):
        q = queries.to(shard.device, non_blocking=True)
        s, i = _shard_search(q, shard, kk, int(sizes[j]), impl, tile, chunk)
        scores.append(s)
        ids.append(i.long() + j * shard_rows)
    return merge_winners(scores, ids, k,
                         len(local) < sharding.num_shards)


class ShardedDenseIndex:
    """Dense index whose storage is row-sharded over the mesh's ``axis``.

    Additions fill the least-loaded shards first so growth stays balanced;
    a host ``sizes`` vector masks each shard's padding. Global ids encode
    (shard, slot), and persistent maps turn them back into external ids in
    O(B*k) host work a search.
    """

    def __init__(self, dim: int, mesh: Mesh, capacity_block: int = 8192,
                 dtype=torch.float32, tile: int = 1024, axis: str = "data"):
        self.dim = dim
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.shape[axis]
        self.tile = tile
        self.dtype = dtype
        self.shard_capacity = max(
            tile, ((capacity_block + self.ndev - 1) // self.ndev + tile - 1)
            // tile * tile)
        self._sizes = np.zeros(self.ndev, np.int32)
        self._local = Sharding(mesh, (axis,)).local_shards()
        self._emb = [torch.zeros(self.shard_capacity, dim, dtype=dtype,
                                 device=dev) for _, dev in self._local]
        #   _rows_by_ext [size]          external id -> storage row
        #   _row_to_ext  [ndev*capacity] storage row -> external id (-1)
        self._rows_by_ext = np.zeros(0, np.int64)
        self._row_to_ext = np.full(self.ndev * self.shard_capacity, -1,
                                   np.int64)

    @property
    def size(self) -> int:
        return int(self._sizes.sum())

    def _grow(self) -> None:
        old_cap = self.shard_capacity
        new_cap = old_cap * 2
        for j, old in enumerate(self._emb):
            grown = torch.zeros(new_cap, self.dim, dtype=self.dtype,
                                device=old.device)
            grown[:old_cap] = old
            self._emb[j] = grown
        self.shard_capacity = new_cap
        # Storage rows moved: shard s's block now starts at s*new_cap.
        self._rows_by_ext = ((self._rows_by_ext // old_cap) * new_cap
                             + self._rows_by_ext % old_cap)
        self._row_to_ext = np.full(self.ndev * new_cap, -1, np.int64)
        self._row_to_ext[self._rows_by_ext] = np.arange(
            len(self._rows_by_ext))

    def _water_fill(self, n: int) -> np.ndarray:
        """Distribute n additions so shard sizes level out (bulk version
        of fill-the-least-loaded-first). Returns per-shard counts."""
        sizes = self._sizes.astype(np.int64)
        counts = np.zeros(self.ndev, np.int64)
        rem = n
        while rem > 0:
            mn = sizes.min()
            lows = np.flatnonzero(sizes == mn)
            higher = sizes[sizes > mn]
            level = higher.min() if higher.size else mn + rem
            take = min(rem, int(level - mn) * len(lows))
            per, extra = divmod(take, len(lows))
            add = np.full(len(lows), per, np.int64)
            add[:extra] += 1
            sizes[lows] += add
            counts[lows] += add
            rem -= take
        return counts

    def _shard_rows(self, counts: np.ndarray, starts: np.ndarray):
        """Storage rows of ``counts[s]`` additions to each shard from slot
        ``starts[s]``, shard after shard."""
        cap = self.shard_capacity
        return np.concatenate([
            s * cap + np.arange(starts[s], starts[s] + counts[s],
                                dtype=np.int64)
            for s in range(self.ndev)])

    def add(self, embeddings) -> np.ndarray:
        """Append embeddings [n, dim] (numpy or a tensor on any device);
        returns dense external ids. Shard s takes the next ``counts[s]``
        rows in order."""
        x = torch.as_tensor(embeddings)
        emb = normalize(x.float() if x.dtype == torch.float64 else x
                        ).to(self.dtype)
        n = emb.shape[0]
        ext_start = len(self._rows_by_ext)
        counts = self._water_fill(n)
        while (self._sizes + counts).max() > self.shard_capacity:
            self._grow()
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for (s, dev), store in zip(self._local, self._emb):
            lo = int(self._sizes[s])
            store[lo:lo + int(counts[s])] = emb[offsets[s]:offsets[s + 1]].to(
                dev)
        rows = self._shard_rows(counts, self._sizes)
        self._sizes = (self._sizes + counts).astype(np.int32)
        ext = np.arange(ext_start, ext_start + n, dtype=np.int64)
        self._rows_by_ext = np.concatenate([self._rows_by_ext, rows])
        self._row_to_ext[rows] = ext
        return ext

    def bulk_build(self, embeddings, batch: int = 1 << 20) -> np.ndarray:
        """One-shot load into an EMPTY index; returns external ids.

        Lays the balanced layout out shard by shard in slabs of ``batch``
        rows (normalise, cast, write), so one slab is the only temporary.
        ``embeddings`` may be numpy (normalised in numpy float32, as the
        reference does, but in a copy: the reference divides the caller's
        float32 rows in place) or a tensor on any device, whose rows then
        never pass through the host.
        """
        if self.size:
            raise ValueError("bulk_build requires an empty index")
        n = int(embeddings.shape[0])
        counts = self._water_fill(n)  # empty index -> balanced split
        while counts.max() > self.shard_capacity:
            self._grow()
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for (s, dev), store in zip(self._local, self._emb):
            for lo in range(0, int(counts[s]), batch):
                hi = min(int(counts[s]), lo + batch)
                src = embeddings[offsets[s] + lo:offsets[s] + hi]
                if isinstance(src, torch.Tensor):
                    sl = normalize(src.to(dev).float())
                else:
                    sl = np.array(src, np.float32)     # never the caller's
                    sl /= np.maximum(np.linalg.norm(sl, axis=1,
                                                    keepdims=True), 1e-12)
                    sl = torch.from_numpy(sl).to(dev)
                store[lo:hi] = sl.to(self.dtype)
                del sl
        self._sizes = counts.astype(np.int32)
        rows = self._shard_rows(counts, np.zeros(self.ndev, np.int64))
        self._rows_by_ext = rows
        self._row_to_ext[rows] = np.arange(n, dtype=np.int64)
        return np.arange(n, dtype=np.int64)

    def search(self, queries, k: int, impl: str = "auto"):
        """Returns (scores [B, k] np.float32, ids [B, k] np.int64; -inf and
        -1 where fewer than k rows exist). Two device-to-host copies."""
        dev = self._local[0][1]
        q = torch.atleast_2d(torch.as_tensor(queries, device=dev))
        q = normalize(q.float())
        b = q.shape[0]
        if self.size == 0 or b == 0:
            return (np.full((b, k), -np.inf, np.float32),
                    np.full((b, k), -1, np.int64))
        kk = min(k, self.size)
        scores, rows = sharded_topk(
            q, self._emb, kk, mesh=self.mesh, sizes=self._sizes,
            axis=self.axis, impl=impl, tile=self.tile)
        scores, rows = scores.cpu().numpy(), rows.cpu().numpy()
        ids = self._row_to_ext[np.clip(rows, 0, len(self._row_to_ext) - 1)]
        # Searches mask padding with the FINITE sentinel NEG_INF; missing
        # hits become -inf / -1 as in every other index.
        dead = (rows < 0) | (scores < NEG_INF / 2)
        ids = np.where(dead, np.int64(-1), ids)
        scores = np.where(dead, -np.inf, scores)
        if kk < k:
            pad = k - kk
            scores = np.pad(scores, ((0, 0), (0, pad)),
                            constant_values=-np.inf)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return scores.astype(np.float32), ids.astype(np.int64)
