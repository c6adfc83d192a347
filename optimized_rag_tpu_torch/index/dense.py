"""Dense embedding index: a padded, growable matrix of unit vectors.

Held against ``optimized_rag_tpu/index/dense.py``. Capacity grows in
blocks and ``size`` masks the tail; deletes are tombstones (zeroed rows,
oversampled past and filtered); vectors are L2-normalised at add time so
cosine is a dot product and search is one top-k dispatch (ops/topk.py).

Storage is float32, bfloat16, float16 or int8 on the index's device.
bfloat16 scans a 4x oversampled candidate set and rescores it in float32;
float16 scans for k directly, as the reference does. int8 stores
per-row quantized codes with a float32 scale per row (ops/quantize.py: 4x
the rows of float32 in the same bytes); its search scans the codes (the
int8-native certified path, or K7), 4x oversampled, and rescores the
dequantized candidates in float32. ``state_dict`` is interchangeable with
the JAX package's: bfloat16 and float16 rows are exported as float32
numpy (exact; numpy has no bfloat16), int8 rows as int8 codes plus
``scale``; the JAX package's bfloat16 snapshot files (raw 2-byte records)
are read bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.ops.quantize import (
    dequantize_int8, quantize_int8)
from optimized_rag_tpu_torch.ops.similarity import normalize
from optimized_rag_tpu_torch.ops.topk import (
    chunked_topk, dispatch_deferred, dispatch_topk, read_count,
    repair_uncovered, rescore_topk)
from optimized_rag_tpu_torch.utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _wait_for(t: torch.Tensor) -> None:
    """Wait until the card has made ``t`` (its current stream drained)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def _first_kept(scores: np.ndarray, ids: np.ndarray, keep: np.ndarray,
                k: int):
    """Each row's first ``k`` entries where ``keep`` holds, in their order,
    padded with -inf and -1 to [B, k]."""
    out_s = np.full((ids.shape[0], k), -np.inf, np.float32)
    out_i = np.full((ids.shape[0], k), -1, np.int64)
    cols = np.argsort(~keep, axis=1, kind="stable")[:, :k]
    kept = np.take_along_axis(keep, cols, 1)
    m = cols.shape[1]
    out_s[:, :m] = np.where(kept, np.take_along_axis(scores, cols, 1),
                            -np.inf)
    out_i[:, :m] = np.where(kept, np.take_along_axis(ids, cols, 1), -1)
    return out_s, out_i


def host_rows(arr, dtype: torch.dtype) -> torch.Tensor:
    """Snapshot rows as a CPU tensor for storage ``dtype``: the JAX
    package's bfloat16 rows, which numpy keeps as raw 2-byte records (it
    has no bfloat16), by their bits; int8 codes and float rows by value."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and dtype == torch.bfloat16:
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(
        arr, np.int8 if dtype == torch.int8 else np.float32))


@dataclasses.dataclass
class DenseSearchResult:
    scores: np.ndarray   # [B, k] f32
    ids: np.ndarray      # [B, k] int64 (-1 for missing)
    # How the batch was searched: "certified" (certificate 0), "fallback"
    # (certificate nonzero: the uncovered pairs repaired, or the exact tiled
    # search rerun) or "direct" (one pass).
    route: str = "direct"


class DenseIndex:
    """Exact dense index over a padded device matrix."""

    def __init__(self, dim: int, capacity_block: int = 65536,
                 dtype=torch.float32, tile: int = 1024, device="cuda"):
        dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        if dtype not in _DTYPES.values():
            raise TypeError(f"unsupported storage dtype {dtype}")
        self.device = resolve_device(device)
        self.dim = dim
        self.capacity_block = _round_up(capacity_block, tile)
        self.tile = tile
        self.dtype = dtype
        self.quantized = dtype == torch.int8
        self.size = 0
        self._emb = torch.zeros((self.capacity_block, dim), dtype=dtype,
                                device=self.device)
        # Per-row dequantization scales of int8 storage.
        self._scale = (torch.zeros(self.capacity_block, device=self.device)
                       if self.quantized else None)
        self._tombstones: set[int] = set()
        # Bumped whenever row -> vector assignments change (delete/compact).
        self.epoch = 0

    # ------------------------------------------------------------- mutation

    @property
    def capacity(self) -> int:
        return self._emb.shape[0]

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = _round_up(needed, self.capacity_block)
        pad = torch.zeros((new_cap - self.capacity, self.dim),
                          dtype=self.dtype, device=self.device)
        if self.quantized:
            self._scale = torch.cat([self._scale, torch.zeros(
                new_cap - self.capacity, device=self.device)])
        self._emb = torch.cat([self._emb, pad])

    def add(self, embeddings) -> np.ndarray:
        """Append embeddings [n, dim]; returns their assigned int64 ids."""
        emb = torch.as_tensor(embeddings).to(self.device)
        assert emb.ndim == 2 and emb.shape[1] == self.dim, emb.shape
        n = emb.shape[0]
        self._ensure_capacity(self.size + n)
        unit = normalize(emb.float())
        if self.quantized:
            rows, scale = quantize_int8(unit)
            self._scale[self.size:self.size + n] = scale
        else:
            rows = unit.to(self.dtype)
        self._emb[self.size:self.size + n] = rows
        ids = np.arange(self.size, self.size + n, dtype=np.int64)
        self.size += n
        return ids

    def delete(self, ids) -> None:
        """Tombstone rows; they stop matching after this call."""
        ids = np.asarray(ids, np.int64)
        live = [int(i) for i in ids if 0 <= i < self.size
                and i not in self._tombstones]
        if not live:
            return
        rows = torch.as_tensor(live, device=self.device)
        self._emb[rows] = 0
        if self.quantized:
            self._scale[rows] = 0.0
        self._tombstones.update(live)
        self.epoch += 1

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows; returns old_id -> new_id mapping (-1 gone)."""
        keep = np.array([i for i in range(self.size)
                         if i not in self._tombstones], np.int64)
        mapping = np.full(self.size, -1, np.int64)
        mapping[keep] = np.arange(len(keep))
        new_cap = max(self.capacity_block, _round_up(len(keep), self.tile))
        new_emb = torch.zeros((new_cap, self.dim), dtype=self.dtype,
                              device=self.device)
        rows = torch.as_tensor(keep, device=self.device)
        if len(keep):
            new_emb[:len(keep)] = self._emb[rows]
        if self.quantized:
            new_scale = torch.zeros(new_cap, device=self.device)
            new_scale[:len(keep)] = self._scale[rows]
            self._scale = new_scale
        self._emb = new_emb
        self.size = len(keep)
        self._tombstones.clear()
        self.epoch += 1
        return mapping

    # --------------------------------------------------------------- search

    def embeddings(self) -> torch.Tensor:
        """The padded device matrix [capacity, dim] (rows >= size are 0).

        Raw storage: int8 codes in quantized mode; ``vectors_f32`` gives
        real-valued rows."""
        return self._emb

    @property
    def row_scale(self):
        """Per-row dequantization scales [capacity] (int8), else None."""
        return self._scale

    def vectors_f32(self, limit: int | None = None) -> torch.Tensor:
        """Float32 unit vectors [limit or size, dim], dequantized in int8
        mode."""
        stop = self.size if limit is None else limit
        if self.quantized:
            return dequantize_int8(self._emb[:stop], self._scale[:stop])
        return self._emb[:stop].float()

    def get(self, ids) -> torch.Tensor:
        rows = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        if self.quantized:
            return dequantize_int8(self._emb[rows], self._scale[rows])
        return self._emb[rows]

    def search(self, queries, k: int, *, prefer_kernel=None
               ) -> DenseSearchResult:
        """Top-k over live rows. queries [B, dim] (any scale).

        Makes ``dispatch_topk``'s calls between spans (``dispatch_deferred``,
        ``read_count``, ``repair_uncovered``); the route is "direct"
        without a ``Cover``, "certified" at a count of 0, else "fallback".

        While a profiler session is active it records ``search`` (B, k,
        cc, route, and the certificate's uncovered count where there is
        one) and, under it, ``search.prepare`` (normalise and copy in),
        ``search.scan`` (the top-k issued), ``search.wait`` (the wait for
        the scan), ``search.fallback`` (the repair, or the whole search's
        rerun, issued after a nonzero certificate; ``pairs``, the pairs the
        covers left, and ``rerun``, whether the whole search reran),
        ``search.rescore`` (the float32 rescore issued) and
        ``search.filter`` (the tombstones). The candidates stay on the card:
        only the certificate's count (after ``search.wait``), the pairs'
        count (in ``search.fallback``) and the answer come back, and no
        span waits for the card only to time it."""
        with span("search") as sp:
            with span("search.prepare"):
                q = normalize(torch.atleast_2d(torch.as_tensor(queries).to(
                    self.device)).float())
            b = q.shape[0]
            if self.size == 0:
                return DenseSearchResult(np.full((b, k), -np.inf, np.float32),
                                         np.full((b, k), -1, np.int64))
            # Oversample past tombstones (zeroed rows score 0.0 and could
            # otherwise crowd out genuinely negative matches).
            slack = min(len(self._tombstones), max(0, self.size - k))
            kk = min(k + slack, self.size)
            # Candidates to scan for: int8 and bf16 oversample 4x in the
            # low-precision scan, then rescore the candidates in float32.
            if self.quantized:
                cc = min(4 * kk, self.size)
            elif self.dtype == torch.bfloat16 and self.size > 4 * kk:
                cc = 4 * kk
            else:
                cc = kk
            with span("search.scan"):
                scores, ids, cover = dispatch_deferred(
                    q, self._emb, cc, size=self.size,
                    prefer_kernel=prefer_kernel, tile=self.tile,
                    row_scale=self._scale)
            with span("search.wait"):
                _wait_for(ids)
            uncovered = None if cover is None else read_count(cover.count)
            route = ("direct" if cover is None else
                     "certified" if uncovered == 0 else "fallback")
            if uncovered:
                with span("search.fallback") as fb:
                    scores, ids, pairs, rerun = repair_uncovered(
                        q, self._emb, cc, self.size, self.tile, scores, ids,
                        cover, row_scale=self._scale)
                    if fb:
                        fb.attrs.update(pairs=pairs, rerun=rerun)
            if sp:
                sp.attrs.update(B=b, k=k, cc=cc, route=route)
                if uncovered is not None:
                    sp.attrs["uncovered"] = uncovered
            if cc != kk or self.quantized:
                with span("search.rescore"):
                    scores, ids = rescore_topk(q, self._emb, ids, kk,
                                               row_scale=self._scale)
            scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
            ids = ids.astype(np.int64)
            if self._tombstones or kk > k:
                with span("search.filter"):
                    gone = np.fromiter(self._tombstones, np.int64,
                                       len(self._tombstones))
                    keep = (ids >= 0) & ~np.isin(ids, gone)
                    return DenseSearchResult(
                        *_first_kept(scores, ids, keep, k), route)
            return DenseSearchResult(scores, ids, route)

    def search_tail(self, queries, k: int, from_row: int
                    ) -> DenseSearchResult:
        """Exact search restricted to rows [from_row, size) — the segment
        added since an ANN index was last built."""
        q = normalize(torch.atleast_2d(torch.as_tensor(queries).to(
            self.device)).float())
        b = q.shape[0]
        if self.size - from_row <= 0:
            return DenseSearchResult(np.full((b, k), -np.inf, np.float32),
                                     np.full((b, k), -1, np.int64))
        start = (from_row // self.tile) * self.tile  # tile-aligned slice
        tail = self._emb[start:start + _round_up(self.size - start,
                                                 self.tile)]
        # Oversample by the alignment slack so pre-from_row rows caught by
        # the aligned slice cannot crowd out genuine tail rows.
        kk = min(k + (from_row - start), self.size - start)
        if self.quantized:
            tail_scale = self._scale[start:start + tail.shape[0]]
            scores, ids = chunked_topk(q, tail, kk, size=self.size - start,
                                       row_scale=tail_scale)
        else:
            scores, ids = dispatch_topk(q, tail, kk, size=self.size - start,
                                        tile=self.tile)
        scores = scores.cpu().numpy()
        ids = ids.cpu().numpy().astype(np.int64) + start
        valid = (ids >= from_row) & (ids < self.size) & np.isfinite(scores)
        return DenseSearchResult(*_first_kept(scores, ids, valid, k))

    # ------------------------------------------------------------- snapshot

    def state_dict(self) -> dict:
        """Snapshot in the JAX package's format (``embeddings`` as numpy:
        float32 rows, or int8 codes with a float32 ``scale``)."""
        rows = self._emb[:self.size]
        state = {
            "dim": self.dim, "size": self.size, "tile": self.tile,
            "capacity_block": self.capacity_block,
            "dtype": str(self.dtype).removeprefix("torch."),
            "embeddings": (rows if self.quantized else rows.float()
                           ).cpu().numpy(),
            "tombstones": np.array(sorted(self._tombstones), np.int64),
        }
        if self.quantized:
            state["scale"] = self._scale[:self.size].cpu().numpy()
        return state

    @classmethod
    def from_state_dict(cls, state: dict, device="cuda") -> "DenseIndex":
        idx = cls(int(state["dim"]), int(state["capacity_block"]),
                  str(state["dtype"]), int(state["tile"]), device=device)
        emb = np.asarray(state["embeddings"])
        rows = host_rows(emb, idx.dtype)
        if len(emb):
            idx._ensure_capacity(len(emb))
            idx._emb[:len(emb)] = rows.to(device=idx.device,
                                          dtype=idx.dtype)
            if idx.quantized:
                idx._scale[:len(emb)] = torch.from_numpy(np.array(
                    state["scale"], np.float32)).to(idx.device)
            idx.size = len(emb)
        idx._tombstones = set(int(i) for i in state.get("tombstones", []))
        return idx
