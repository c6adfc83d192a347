"""On-device k-means for IVF centroid training.

Held against ``optimized_rag_tpu/ops/kmeans.py``: Lloyd iterations on the
caller's device. Assignment is a float32 matmul and an argmax (ties to the
lower centroid, as ``jnp.argmax``), the centroid update a segment sum
(``index_add_``), and empty clusters are reseeded from the points that fit
their centroid worst. Every product runs in full float32 (TF32 off,
``device.configure_numerics``); rows in 16-bit storage are cast to float32
before the product, chunk by chunk.

Two departures from the reference, neither a knob:

* The initial centroids are drawn by a ``torch.Generator`` seeded from
  ``seed`` on the CPU (Threefry does not exist in torch), so the card and
  the CPU pick the same init for one seed, but not the JAX package's.
  ``_init_centroids`` and ``_lloyd`` are separate so a test can start the
  loop from the JAX init.
* Lloyd's assignment runs in chunks of ``_LLOYD_CHUNK`` rows, so the
  [rows, C] similarity block stays bounded (the reference materialises it
  whole). Each row's argmax is its own, so the function is the same.

On CUDA ``index_add_`` adds in no fixed order: centroids built on the card
differ from the CPU's by ulps, and an assignment near a tie may flip.
"""

from __future__ import annotations

import numpy as np
import torch

from optimized_rag_tpu_torch.ops.similarity import normalize
from optimized_rag_tpu_torch.ops.topk import _topk

_LLOYD_CHUNK = 1 << 20


def _assign(points: torch.Tensor, c_norm: torch.Tensor, chunk: int):
    """Best centroid of ``c_norm`` (as given) for each point, ``chunk`` rows
    at a time: (assignment [N] int32, best_sim [N] f32)."""
    parts_a, parts_s = [], []
    for lo in range(0, points.shape[0], chunk):
        sims = points[lo:lo + chunk].float() @ c_norm.T
        best, arg = torch.max(sims, dim=1)
        del sims
        parts_a.append(arg.int())
        parts_s.append(best)
    if len(parts_a) == 1:
        return parts_a[0], parts_s[0]
    return torch.cat(parts_a), torch.cat(parts_s)


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor,
                  chunk: int = 65536):
    """Assign each point to its nearest centroid (cosine / dot metric).

    points [N, D] (normalized, any float dtype incl. bfloat16 storage),
    centroids [C, D]. Returns (assignment [N] int32, best_sim [N] f32).
    Chunked over N so only one chunk is ever cast to float32 at a time.
    """
    return _assign(points, normalize(centroids).float(), chunk)


def balanced_assign(points: torch.Tensor, centroids: torch.Tensor, cap: int,
                    top: int = 8, chunk: int = 65536) -> np.ndarray:
    """Capacity-capped cluster assignment (balanced IVF).

    Each point goes to its best-affinity centroid whose cluster still has
    room (greedy, rank-round robin over each point's top-``top`` choices;
    stragglers fill the least-loaded clusters). Equal-size clusters make
    every IVF probe window about ceil(N/C) rows instead of the largest
    cluster's size. The choices are computed on the points' device; the
    rounds run on the host in numpy, as the reference's do.

    Returns assignment [N] int32 (numpy) with bincount(assign) <= cap.
    """
    n = points.shape[0]
    c = centroids.shape[0]
    if cap * c < n:
        raise ValueError(f"cap {cap} x {c} clusters < {n} points")
    c_norm = normalize(centroids).float()
    t = min(top, c)
    ch_i, ch_s = [], []
    for lo in range(0, n, chunk):
        sims = points[lo:lo + chunk].float() @ c_norm.T
        s, i = _topk(sims, t)
        del sims
        ch_i.append(i.int().cpu().numpy())
        ch_s.append(s.cpu().numpy())
    choices = np.concatenate(ch_i)          # [N, T]
    scores = np.concatenate(ch_s)           # [N, T]
    assign = np.full(n, -1, np.int64)
    load = np.zeros(c, np.int64)
    for r in range(choices.shape[1]):
        un = np.flatnonzero(assign < 0)
        if not len(un):
            break
        cc = choices[un, r].astype(np.int64)
        ss = scores[un, r]
        order = np.lexsort((-ss, cc))       # by cluster, best first
        un_o, c_o = un[order], cc[order]
        # rank within each cluster run
        starts = np.r_[0, np.flatnonzero(np.diff(c_o)) + 1]
        run_len = np.diff(np.r_[starts, len(c_o)])
        rank = np.arange(len(c_o)) - np.repeat(starts, run_len)
        take = rank < (cap - load)[c_o]
        assign[un_o[take]] = c_o[take]
        load += np.bincount(c_o[take], minlength=c)
    un = np.flatnonzero(assign < 0)
    if len(un):  # stragglers: round-robin into remaining room
        room_ids = np.repeat(np.arange(c), np.maximum(cap - load, 0))
        assign[un] = room_ids[: len(un)]
    return assign.astype(np.int32)


def _init_centroids(pts: torch.Tensor, num_clusters: int, seed: int,
                    valid: torch.Tensor) -> torch.Tensor:
    """``num_clusters`` valid points drawn with replacement, uniformly over
    the valid rows, by a CPU generator seeded from ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    idx = torch.multinomial(valid.cpu().float(), num_clusters,
                            replacement=True, generator=gen)
    return pts[idx.to(pts.device)]


def _lloyd(pts: torch.Tensor, centroids: torch.Tensor, iters: int,
           valid: torch.Tensor, chunk: int = _LLOYD_CHUNK) -> torch.Tensor:
    """``iters`` Lloyd steps from ``centroids`` over unit float32 points:
    invalid rows parked in cluster C, the centroid the mean of its rows
    (counts floored at 1e-6), an empty cluster j reseeded with the j-th
    worst-fitting valid point (stable ascending order of best similarity),
    every step ending in ``normalize``."""
    c, d = centroids.shape
    w = valid.float()
    weighted = pts * w[:, None]
    for _ in range(iters):
        assign, best = _assign(pts, normalize(centroids).float(), chunk)
        assign = torch.where(valid, assign, c).long()
        sums = torch.zeros(c + 1, d, device=pts.device).index_add_(
            0, assign, weighted)
        counts = torch.zeros(c + 1, device=pts.device).index_add_(
            0, assign, w)
        sums, counts = sums[:c], counts[:c]
        new = sums / torch.clamp_min(counts[:, None], 1e-6)
        worst = torch.argsort(torch.where(valid, best, float("inf")),
                              stable=True)[:c]
        empty = counts < 0.5
        new = torch.where(empty[:, None], pts[worst], new)
        centroids = normalize(new)
    return centroids


def kmeans_fit(points: torch.Tensor, num_clusters: int, iters: int = 12,
               seed: int = 0, valid: torch.Tensor | None = None):
    """Spherical k-means (cosine metric) on points [N, D].

    Returns (centroids [C, D] f32 normalized, assignment [N] int32), on the
    points' device. ``valid`` masks padded rows; invalid rows are assigned
    cluster 0 but do not influence centroids.
    """
    pts = normalize(points).float()
    if valid is None:
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    valid = valid.to(device=pts.device, dtype=torch.bool)
    centroids = _lloyd(pts, _init_centroids(pts, num_clusters, seed, valid),
                       iters, valid)
    assign, _ = _assign(pts, centroids, _LLOYD_CHUNK)
    return centroids, torch.where(valid, assign, 0).int()
