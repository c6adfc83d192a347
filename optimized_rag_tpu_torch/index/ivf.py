"""IVF (inverted-file) cluster-pruned dense index.

Held against ``optimized_rag_tpu/index/ivf.py``. Centroids are trained on
the index's device with spherical k-means (ops/kmeans.py); embeddings are
stored *cluster-sorted* in one flat [Npad, D] matrix so probing a cluster
reads a contiguous window of rows.

Query plan (on the index's device):
  1. score the queries against the centroids (float32), take the top
     ``nprobe`` clusters, ties to the lower cluster;
  2. for each probed cluster in turn, gather a [B, window, D] block at
     ``min(start, Npad - window)``, score it in float32, mask positions
     outside the cluster's range, and merge into a running top-k in which
     earlier candidates stay ahead of later ones at equal score (the
     reference's ``lax.top_k`` over ``[best, new]``);
  3. map slot positions back to caller ids through the sort permutation.

The window is the largest cluster rounded to the tile (to 128 for a
balanced build). Rows in 16-bit storage are cast to float32 before every
product. Snapshots use the JAX package's layout; 16-bit rows are written as
float32 numpy beside a ``dtype`` key (which the JAX package ignores), and
the JAX package's bfloat16 rows, raw 2-byte records, are read by their
bits.
"""

from __future__ import annotations

import numpy as np
import torch

from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.index.dense import host_rows
from optimized_rag_tpu_torch.ops.kmeans import (
    balanced_assign, kmeans_assign, kmeans_fit)
from optimized_rag_tpu_torch.ops.similarity import normalize
from optimized_rag_tpu_torch.ops.topk import _topk
from optimized_rag_tpu_torch.ops.topk_kernels import NEG_INF

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _probe_clusters(q, centroids, nprobe: int, owned=None):
    """The ``nprobe`` best clusters of each query [B, nprobe], ties to the
    lower cluster. ``owned`` [C] bool restricts probing to a cluster subset
    (the sharded composition masks each shard to its own clusters)."""
    cent_scores = q @ centroids.T                                # [B, C]
    if owned is not None:
        cent_scores = torch.where(owned[None, :], cent_scores, NEG_INF)
    return _topk(cent_scores, nprobe)[1]


def _ivf_search(q, centroids, sorted_emb, starts, counts, k: int,
                nprobe: int, window: int, owned=None):
    """q [B,D] normalized f32; sorted_emb [Npad, D]; starts/counts [C].

    ``owned`` [C] bool restricts probing to a cluster subset; None probes
    everything.

    Returns (scores [B,k], slots [B,k] int64) where slots index sorted_emb
    rows.
    """
    b = q.shape[0]
    npad = sorted_emb.shape[0]
    probe = _probe_clusters(q, centroids, nprobe, owned)         # [B, nprobe]
    offsets = torch.arange(window, device=q.device)
    best_s = torch.full((b, k), NEG_INF, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.long, device=q.device)
    for p in range(nprobe):
        start = starts[probe[:, p]].long()                       # [B]
        count = counts[probe[:, p]].long()                       # [B]
        start_cl = torch.clamp(start, max=npad - window)
        pos = start_cl[:, None] + offsets[None, :]               # [B, window]
        block = sorted_emb[pos].float()                       # [B, window, D]
        s = torch.bmm(block, q[:, :, None]).squeeze(-1)          # [B, window]
        del block
        valid = (pos >= start[:, None]) & (pos < (start + count)[:, None])
        cand_s = torch.cat([best_s, torch.where(valid, s, NEG_INF)], dim=1)
        cand_i = torch.cat([best_i, pos], dim=1)
        best_s, sel = _topk(cand_s, k)
        best_i = torch.gather(cand_i, 1, sel)
    return best_s, best_i


def _storage_dtype(state: dict) -> torch.dtype:
    """The rows' storage: the port's ``dtype`` key, else (the JAX package's
    state) what the array holds."""
    if "dtype" in state:
        return _DTYPES[str(state["dtype"])]
    arr = np.asarray(state["sorted_emb"])
    if arr.dtype.itemsize == 2:
        return (torch.float16 if arr.dtype == np.float16
                else torch.bfloat16)
    return torch.float32


class IVFIndex:
    """Cluster-pruned index built from a frozen set of embeddings.

    Build once over the current corpus (like ``CREATE INDEX``); incremental
    adds go to the exact DenseIndex until the next rebuild — the engine
    unions both result sets, so freshness never costs recall.
    """

    def __init__(self, num_clusters: int = 1024, nprobe: int = 64,
                 kmeans_iters: int = 12, tile: int = 1024, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.num_clusters = num_clusters
        self.nprobe = nprobe
        self.kmeans_iters = kmeans_iters
        self.tile = tile
        self.seed = seed
        self.size = 0
        self.num_clusters_built = 0
        self._centroids = None      # [C, D] f32
        self._sorted_emb = None     # [Npad, D] cluster-sorted
        self._starts = None         # [C] int32 slot offsets
        self._counts = None         # [C] int32
        self._perm = None           # [N] slot -> original id (np.int64)
        self._window = 0

    def build(self, embeddings, ids=None, storage_dtype=torch.float32,
              train_sample: int = 1 << 21, balanced: bool = False,
              cap_factor: float = 1.15) -> None:
        """Train centroids and lay out cluster-sorted storage.

        embeddings [N, D] (unnormalized ok; numpy or a tensor on any
        device); ids [N] original doc ids (defaults to arange).
        ``storage_dtype=torch.bfloat16`` halves the rows' bytes. Centroids
        train on the first ``train_sample`` rows; assignment of the full
        corpus is chunked.

        ``balanced=True`` caps clusters at cap_factor*ceil(N/C) via
        affinity-greedy reassignment (ops/kmeans.balanced_assign), so the
        probe window is about the mean cluster size instead of the max.
        Displaced points sit in near-best clusters; recover recall with a
        slightly higher nprobe.
        """
        x = torch.as_tensor(embeddings, device=self.device)
        emb = normalize(x.float() if x.dtype == torch.float64 else x
                        ).to(storage_dtype)
        del x
        n, d = emb.shape
        c = min(self.num_clusters, max(1, n // 4))
        centroids, _ = kmeans_fit(emb[: min(n, train_sample)].float(), c,
                                  iters=self.kmeans_iters, seed=self.seed)
        if balanced:
            cap = max(1, int(np.ceil(n / c * cap_factor)))
            # Small chunks: the [chunk, C] similarity block and its sort
            # materialise.
            assign = torch.from_numpy(balanced_assign(
                emb, centroids, cap, chunk=1 << 16)).to(self.device)
            window_round = 128  # window ~= cap, not tile-rounded
        else:
            assign, _ = kmeans_assign(emb, centroids, chunk=1 << 20)
            window_round = self.tile
        order = torch.argsort(assign, stable=True)
        counts = torch.bincount(assign, minlength=c).int()
        starts = torch.zeros(c, dtype=torch.int32, device=self.device)
        starts[1:] = torch.cumsum(counts, 0)[:-1]
        self._window = max(window_round,
                           _round_up(int(counts.max()) or 1, window_round))
        npad = _round_up(n, self.tile) + self._window  # slack for clamping
        # Cluster-sort on the device, into storage with the padding rows.
        self._sorted_emb = torch.zeros(npad, d, dtype=storage_dtype,
                                       device=self.device)
        torch.index_select(emb, 0, order, out=self._sorted_emb[:n])
        del emb
        self._centroids = centroids
        self._starts = starts
        self._counts = counts
        order = order.cpu().numpy()
        src_ids = (np.arange(n, dtype=np.int64) if ids is None
                   else np.asarray(ids, np.int64))
        self._perm = src_ids[order]
        self.size = n
        self.num_clusters_built = c

    def search(self, queries, k: int, nprobe: int | None = None):
        """Returns (scores [B,k] np.f32, ids [B,k] np.int64; -1 missing)."""
        if self._sorted_emb is None:
            raise RuntimeError("build() first")
        q = torch.as_tensor(queries, device=self.device)
        q = normalize(torch.atleast_2d(q).float())
        nprobe = min(nprobe or self.nprobe, self.num_clusters_built)
        scores, slots = _ivf_search(
            q, self._centroids, self._sorted_emb, self._starts, self._counts,
            k=min(k, self.size), nprobe=nprobe, window=self._window)
        scores = scores.cpu().numpy()
        slots = slots.cpu().numpy()
        ids = np.where(slots >= 0,
                       self._perm[np.clip(slots, 0, self.size - 1)], -1)
        miss = scores < NEG_INF / 2
        out_s = np.where(miss, -np.inf, scores).astype(np.float32)
        out_i = np.where(miss, -1, ids)
        if out_s.shape[1] < k:  # pad when corpus smaller than k
            pad = k - out_s.shape[1]
            out_s = np.pad(out_s, ((0, 0), (0, pad)),
                           constant_values=-np.inf)
            out_i = np.pad(out_i, ((0, 0), (0, pad)), constant_values=-1)
        return out_s, out_i

    def state_dict(self) -> dict:
        return {
            "num_clusters": self.num_clusters, "nprobe": self.nprobe,
            "kmeans_iters": self.kmeans_iters, "tile": self.tile,
            "seed": self.seed, "size": self.size, "window": self._window,
            "num_clusters_built": self.num_clusters_built,
            "dtype": str(self._sorted_emb.dtype).removeprefix("torch."),
            "centroids": self._centroids.cpu().numpy(),
            "sorted_emb": self._sorted_emb.float().cpu().numpy(),
            "starts": self._starts.cpu().numpy(),
            "counts": self._counts.cpu().numpy(),
            "perm": self._perm,
        }

    @classmethod
    def from_state_dict(cls, s: dict, device="cuda") -> "IVFIndex":
        idx = cls(int(s["num_clusters"]), int(s["nprobe"]),
                  int(s["kmeans_iters"]), int(s["tile"]), int(s["seed"]),
                  device=device)
        dev = idx.device
        idx.size = int(s["size"])
        idx._window = int(s["window"])
        idx.num_clusters_built = int(s["num_clusters_built"])
        idx._centroids = torch.from_numpy(np.array(
            s["centroids"], np.float32)).to(dev)
        dtype = _storage_dtype(s)
        idx._sorted_emb = host_rows(s["sorted_emb"], dtype).to(dev, dtype)
        idx._starts = torch.from_numpy(np.array(s["starts"], np.int32)).to(dev)
        idx._counts = torch.from_numpy(np.array(s["counts"], np.int32)).to(dev)
        idx._perm = np.asarray(s["perm"], np.int64)
        return idx
