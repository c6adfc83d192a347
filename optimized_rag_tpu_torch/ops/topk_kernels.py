"""The top-k kernels of the search path: CUDA launches and plain twins.

Held against ``optimized_rag_tpu/ops/topk.py`` and the reference's kernel
sweeps:

* ``packed_extract`` (K1) ports ``_packed_extract_kernel`` /
  ``_pack_tile_scores`` (:511-527, :576-618), launched by ``_packed_pass``;
* ``extract`` (K4) ports ``_extract_kernel`` / ``_extract_rounds``
  (:992-1018, :1053-1066), launched by ``_extract_pass``;
* ``tile_topk`` (K6) ports ``_tile_topk_kernel`` / ``_extract_tile_winners``
  (:142-175), launched by ``_tile_pass``;
* ``packed_extract_int8`` (K3) ports ``_packed_extract_int8_kernel``
  (:548-573) and ``extract_int8`` (K5b) ports ``_extract_int8_kernel``
  (:1037-1050): int8 query codes against int8 row codes, the int32 dot then
  ``(float(i32) * row_scale) * query_scale``;
* ``packed_extract_scaled`` (K2) ports ``_packed_extract_scaled_kernel``
  (:530-545), ``extract_scaled`` (K5a) ``_extract_scaled_kernel``
  (:1021-1034) and ``tile_topk_scaled`` (K7) ``_tile_topk_scaled_kernel``
  (:178-195): the query rounded to bf16 against the rows rounded to bf16
  (int8 codes are exact), an f32 sum, x row_scale;
* ``scan_floor`` (F) ports ``_floor_kernel`` of
  ``benchmarks/sweep_r4_kernel.py:128`` (F1) and
  ``benchmarks/sweep_r4c.py:157`` (F2), one function: the per-tile max of
  K1's scores.

K1 and F over bf16/f16 rows and K2 over int8 codes and bf16 rows score on
the tensor cores (wgmma fed by TMA, f32 accumulation, ``csrc/scan_mma.cuh``)
and keep those sums: the packed words are quantised bounds, and
``scan_accumulation`` admits only the (tile, D) pairs where the tensor
cores' rounding plus the c1 rescore's stays within one quantisation step,
for normalised queries and the route's rows (the card checks the queries'
norms into the range flag). K3 runs there too, s8 x s8 -> s32, exact. K1
and F over f32 rows, and K2 over f16 and f32 rows, run f32 FMA on the CUDA
cores. ``scan_sums`` exposes the tensor cores' raw sums, by which the card
tests hold that rounding to its bound.

K1, K4, K6 and F cast the queries to the corpus dtype (the TPU kernels'
operand cast) and widen them to float32; K2, K5a and K7 round them to bf16.
A CPU corpus takes the plain twin (``*_plain``, torch.matmul in float32 plus
elementwise ops, the same function); a CUDA corpus launches the kernel from
``csrc/`` or raises. Each launch adds one to its count in
``launch_counts()``.

The int8-native score is exact: the code dot is an integer, which the
twins take as float32 products of at most ``_EXACT_CODES`` codes a chunk
(every partial sum an integer below 2**24, exact in any summation order,
TF32 off) added in int32. K3's words and K5b's values are therefore bit for
bit their twins', at any width.

``size`` (live rows) may be an int or a device scalar; rows at or after it
pack to 0 in K1, K2 and K3 and score -1e30 in K4, K5a, K5b, K6 and K7.
The certified path needs every live score in (-2, 2): the twins of K1, K2,
K3 and the covers raise ``ValueError`` otherwise, and the kernels K1, K2
and K3 set their ``flag`` (int32 [1] on the card), which ``ops/topk.py``
carries to where the certificate is read.
"""

from __future__ import annotations

import math
import threading

import torch

NEG_INF = -1e30
KERNELS = ("packed_extract", "extract", "tile_topk", "packed_extract_int8",
           "extract_int8", "tile_topk_scaled", "packed_extract_scaled",
           "extract_scaled", "scan_floor")
# The largest tile the selection kernels (K4, K5a, K5b, K6, K7) take. They
# stream a tile in chunks of 128 rows at 64 queries a block, so neither
# their shared memory nor their queries a block depend on the tile; the
# limit is the largest tile the card tests hold them at.
MAX_EXTRACT_TILE = 16384
# The most unit winners (tile / groups) a packed-scan block keeps for each
# of its 16 queries (csrc/packed_extract.cu).
MAX_UNITS = 2048
RANGE_ERROR = ("certified top-k needs every score in (-2, 2), and over "
               "bf16/f16 rows on the card normalised queries (the scan's "
               "rounding bound); normalize queries and corpus rows")

_counts_lock = threading.Lock()
_launches = dict.fromkeys(KERNELS, 0)

# Largest [B, rows] score block a plain twin materialises at once.
_PLAIN_BLOCK = 1 << 24
# Codes whose float32 dot is exact: 1040 * 127**2 < 2**24.
_EXACT_CODES = 1040


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    with _counts_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in _launches:
            _launches[name] = 0


# --------------------------------------------------------------- plain twins

def _live(rows: torch.Tensor, size) -> torch.Tensor:
    return torch.ones_like(rows, dtype=torch.bool) if size is None \
        else rows < size


def _check_score_range(s: torch.Tensor, live: torch.Tensor) -> None:
    """The certified path's precondition (reference topk.py:1256-1262): a
    live score at or below -2 would alias the padding value after the +2
    shift and drop out while the certificate still reads exact."""
    bad = ((s <= -2.0) | (s >= 2.0)) & live
    if bool(bad.any()):
        raise ValueError(RANGE_ERROR)


def _tiles_per_block(b: int, tile: int) -> int:
    return max(1, _PLAIN_BLOCK // max(b * tile, 1))


def int8_dot(q8: torch.Tensor, rows8: torch.Tensor) -> torch.Tensor:
    """The exact int32 dot of codes ``q8`` [B, D] and ``rows8`` [..., R, D]:
    [..., B, R] int32, at any D (float32 products of at most _EXACT_CODES
    codes, each an exact integer, summed in int32)."""
    out = None
    for lo in range(0, q8.shape[-1], _EXACT_CODES):
        hi = lo + _EXACT_CODES
        part = torch.matmul(q8[:, lo:hi].float(), rows8[..., lo:hi].float()
                            .transpose(-1, -2)).to(torch.int32)
        out = part if out is None else out + part
    return out


def scaled_rows_dtype(corpus: torch.Tensor):
    """What the scaled kernels round float rows to (int8 codes are exact)."""
    return None if corpus.dtype == torch.int8 else torch.bfloat16


def _score(q: torch.Tensor, rows: torch.Tensor, row_scale=None,
           q_scale=None, rows_dtype=None) -> torch.Tensor:
    """Scores [..., B, R] of queries [B, D] against rows [..., R, D] (rounded
    to ``rows_dtype`` first where given), then ``* row_scale`` [..., R] and
    ``* q_scale`` [B], in that order. int8 queries take the exact int8 dot."""
    if q.dtype == torch.int8:
        s = int8_dot(q, rows).float()
    else:
        if rows_dtype is not None:
            rows = rows.to(rows_dtype)
        s = torch.matmul(q, rows.float().transpose(-1, -2))
    if row_scale is not None:
        s = s * row_scale.unsqueeze(-2)
    if q_scale is not None:
        s = s * q_scale[:, None]
    return s


def packed_extract_plain(q: torch.Tensor, corpus: torch.Tensor, size,
                         tile: int, groups: int, row_scale=None,
                         q_scale=None, rows_dtype=None) -> torch.Tensor:
    """K1's function in PyTorch: int32 [T, 2, B] packed unit winners
    (scored as K3 with int8 ``q`` and ``q_scale``, as K2 with
    ``row_scale`` and ``rows_dtype``)."""
    n, _ = corpus.shape
    b = q.shape[0]
    num_tiles, small = n // tile, tile // groups
    dev = corpus.device
    out = torch.empty((num_tiles, 2, b), dtype=torch.int32, device=dev)
    col = torch.arange(tile, dtype=torch.int32, device=dev)
    step = _tiles_per_block(b, tile)
    for t0 in range(0, num_tiles, step):
        t1 = min(num_tiles, t0 + step)
        nt = t1 - t0
        lo, hi = t0 * tile, t1 * tile
        s = _score(q, corpus[lo:hi],
                   None if row_scale is None else row_scale[lo:hi],
                   q_scale, rows_dtype).view(b, nt, tile)
        rows = torch.arange(t0 * tile, t1 * tile, device=dev).view(nt, tile)
        live = _live(rows, size)
        _check_score_range(s, live)
        sh = torch.where(live, torch.clamp_min(s + 2.0, 0.0), 0.0)
        packed = (sh.view(torch.int32) & -tile) | col
        gw = packed.view(b, nt, groups, small).amax(dim=2)   # unit winners
        w0 = gw.amax(dim=-1)
        w1 = torch.where(gw == w0[..., None], 0, gw).amax(dim=-1)
        out[t0:t1, 0] = w0.T
        out[t0:t1, 1] = w1.T
    return out


def _quantise(s: torch.Tensor, tile: int) -> torch.Tensor:
    """The value bits K1 packs for a score: max(s + 2, 0), low bits clear."""
    return torch.clamp_min(s + 2.0, 0.0).view(torch.int32) & -tile


def _named_row_scores(q, corpus, words, tile, row_scale=None,
                      rows_dtype=None, block=1 << 16):
    """(rows, f32 scores) of the row each packed word [T, 2, B] names, by a
    rowwise float32 dot, an order of summation neither scan uses."""
    t, two, b = words.shape
    dev = corpus.device
    rows = ((torch.arange(t, device=dev) * tile)[:, None, None]
            + (words & (tile - 1)).long()).reshape(-1)
    qi = torch.arange(b, device=dev).repeat(t * two)
    s = torch.empty(rows.shape, dtype=torch.float32, device=dev)
    for lo in range(0, rows.numel(), block):
        hi = lo + block
        r = corpus[rows[lo:hi]]
        if rows_dtype is not None:
            r = r.to(rows_dtype)
        s[lo:hi] = (r.float() * q[qi[lo:hi]]).sum(-1)
        if row_scale is not None:
            s[lo:hi] *= row_scale[rows[lo:hi]]
    return rows.view(words.shape), s.view(words.shape)


# The most (tile, query) pairs whose differing words ``packed_word_faults``
# examines against every row of their tile.
_MAX_PAIRS_HELD = 1 << 14


def _tile_scores(q, corpus, t, b, tile, row_scale, rows_dtype):
    """f32 scores [P, tile] of every row of tile t[p] for query b[p], by the
    rowwise dot of ``_named_row_scores``."""
    rows = t[:, None] * tile + torch.arange(tile, device=corpus.device)
    r = corpus[rows]
    if rows_dtype is not None:
        r = r.to(rows_dtype)
    s = (r.float() * q[b][:, None, :]).sum(-1)
    if row_scale is not None:
        s = s * row_scale[rows]
    return rows, s


def _pairs_admissible(q, corpus, size, tile, groups, words, t, b, drift,
                      row_scale, rows_dtype, block_rows=1 << 16):
    """bool [P]: whether the two words of (tile t[p], query b[p]) are K1's
    exact packing of that tile for some scores each within ``drift`` of
    the row's own (dead rows pack to their column alone): both words
    reachable by the rows they name, in distinct units, the first above the
    second, and every other row's lowest reachable word below the first
    (in the first's unit) or below the second (elsewhere)."""
    small = tile // groups
    cols = torch.arange(tile, device=corpus.device, dtype=torch.int32)
    unit = cols % small
    ok = torch.zeros(t.shape[0], dtype=torch.bool, device=corpus.device)
    step = max(1, block_rows // tile)
    for lo in range(0, t.shape[0], step):
        tt, bb = t[lo:lo + step], b[lo:lo + step]
        rows, s = _tile_scores(q, corpus, tt, bb, tile, row_scale,
                               rows_dtype)
        live = rows < size
        low = torch.where(live, _quantise(s - drift, tile), 0) | cols
        high = torch.where(live, _quantise(s + drift, tile), 0) | cols
        w1, w2 = words[tt, 0, bb], words[tt, 1, bb]
        c1, c2 = (w1 & (tile - 1)).long(), (w2 & (tile - 1)).long()

        def reachable(w, c):
            return ((low.gather(1, c[:, None])[:, 0] <= w)
                    & (w <= high.gather(1, c[:, None])[:, 0]))
        good = (w1 > w2) & reachable(w1, c1)
        others = cols[None, :] != c1[:, None]
        if small > 1:
            good &= reachable(w2, c2) & (unit[c1] != unit[c2])
            others &= cols[None, :] != c2[:, None]
        else:                          # one unit: no second winner
            good &= w2 == 0
        below = torch.where(unit[None, :] == unit[c1][:, None], w1[:, None],
                            w2[:, None])
        good &= ~(others & (low >= below)).any(dim=1)
        ok[lo:lo + step] = good
    return ok


def packed_word_faults(q: torch.Tensor, corpus: torch.Tensor, size,
                       tile: int, words: torch.Tensor, ref: torch.Tensor,
                       drift: float = 1e-5, row_scale=None,
                       rows_dtype=None, groups: int = 8):
    """Hold packed words [T, 2, B] (K1's, or K2's with ``row_scale`` and
    ``rows_dtype``) against the rows they name.

    ``q`` are the scan queries (``_scan_queries``, or rounded to bf16 for
    K2); ``words`` and ``ref`` are two computations of the scan's function
    at ``groups``, a kernel's and its twin's. A word is at fault when its
    value bits are nonzero and its column names a row at or after
    ``size``, or a row whose exact score, moved by up to ``drift`` either
    way, does not quantise to those bits; or when it differs from ``ref``
    and the two words of its tile and query are not the exact packing of
    that tile for any scores within ``drift`` of the exact ones
    (``_pairs_admissible``). So a row within ``drift`` of a quantisation
    boundary may move its own word by one step, and the words' order with
    it (one scan ranks it first where the other ranks it below two rows of
    its lower step), but no other word may stand in for it. Past
    ``_MAX_PAIRS_HELD`` differing (tile, query) pairs (a kernel that far
    off is at fault anyway) the rest count as faults unexamined.

    Returns (faults, boundary): the count of words at fault, and of words
    that differ from ``ref`` only as such a boundary row explains.
    """
    size = corpus.shape[0] if size is None else size
    rows, s = _named_row_scores(q, corpus, words, tile, row_scale,
                                rows_dtype)
    lo, hi = _quantise(s - drift, tile), _quantise(s + drift, tile)
    value = words & -tile
    wrong = (value != 0) & ((rows >= size) | (value < lo) | (value > hi))
    differ = words != ref
    t, b = differ.any(dim=1).nonzero(as_tuple=True)
    t, b = t[:_MAX_PAIRS_HELD], b[:_MAX_PAIRS_HELD]
    pair_ok = torch.zeros(differ.shape[0], differ.shape[2], dtype=torch.bool,
                          device=words.device)
    pair_ok[t, b] = _pairs_admissible(q, corpus, size, tile, groups, words,
                                      t, b, drift, row_scale, rows_dtype)
    explained = differ & pair_ok[:, None, :]
    fault = wrong | (differ & ~explained)
    return int(fault.sum()), int((explained & ~fault).sum())


def _extract_rounds_plain(s: torch.Tensor, rounds: int):
    """``rounds`` of max / first-index argmax / mask over the last axis."""
    s = s.clone()
    vals, cols = [], []
    for _ in range(rounds):
        m, a = s.max(dim=-1)          # ties: first (lowest) index
        vals.append(m)
        cols.append(a)
        s.scatter_(-1, a[..., None], NEG_INF)
    return torch.stack(vals, dim=-1), torch.stack(cols, dim=-1)


def _extract_tiles_plain(q, corpus, size, tile, rounds, tile_ids,
                         check_range=False, row_scale=None, q_scale=None,
                         rows_dtype=None):
    """Exact top-``rounds`` of each listed tile: (val, col) [U, rounds, B],
    columns local to their tile."""
    n, d = corpus.shape
    dev = corpus.device
    c = corpus.view(n // tile, tile, d)[tile_ids]                # [U, tile, D]
    cs = (None if row_scale is None
          else row_scale.view(n // tile, tile)[tile_ids])        # [U, tile]
    s = _score(q, c, cs, q_scale, rows_dtype)                     # [U, B, tile]
    rows = tile_ids[:, None] * tile + torch.arange(tile, device=dev)
    live = _live(rows, size)[:, None, :]
    if check_range:
        _check_score_range(s, live)
    s = torch.where(live, s, NEG_INF)
    val, col = _extract_rounds_plain(s, rounds)                   # [U, B, r]
    return (val.permute(0, 2, 1).contiguous(),
            col.permute(0, 2, 1).to(torch.int32).contiguous())


def extract_plain(q: torch.Tensor, corpus: torch.Tensor, size, tile: int,
                  rounds: int, tiles: torch.Tensor):
    """K4's function in PyTorch: (val f32, col int32), each [U, rounds, B]."""
    return _extract_tiles_plain(q, corpus, size, tile, rounds, tiles.long(),
                                check_range=True)


def _tile_topk_plain(q, corpus, size, tile, tile_k, row_scale=None,
                     rows_dtype=None):
    num_tiles = corpus.shape[0] // tile
    dev = corpus.device
    vals, ids = [], []
    step = _tiles_per_block(q.shape[0], tile)
    for t0 in range(0, num_tiles, step):
        tile_ids = torch.arange(t0, min(num_tiles, t0 + step), device=dev)
        v, c = _extract_tiles_plain(q, corpus, size, tile, tile_k, tile_ids,
                                    row_scale=row_scale,
                                    rows_dtype=rows_dtype)
        vals.append(v)
        ids.append(c + (tile_ids * tile).to(torch.int32)[:, None, None])
    return torch.cat(vals), torch.cat(ids)


def tile_topk_plain(q: torch.Tensor, corpus: torch.Tensor, size, tile: int,
                    tile_k: int):
    """K6's function in PyTorch: (s f32, i int32 global ids), each
    [T, tile_k, B]."""
    return _tile_topk_plain(q, corpus, size, tile, tile_k)


def packed_extract_int8_plain(q8: torch.Tensor, q_scale: torch.Tensor,
                              corpus: torch.Tensor, row_scale: torch.Tensor,
                              size, tile: int, groups: int) -> torch.Tensor:
    """K3's function in PyTorch: K1's packed words [T, 2, B] of the scores
    ``(float(q8 . c8) * row_scale) * q_scale`` (the dot exact)."""
    return packed_extract_plain(q8, corpus, size, tile, groups,
                                row_scale=row_scale, q_scale=q_scale)


def extract_int8_plain(q8: torch.Tensor, q_scale: torch.Tensor,
                       corpus: torch.Tensor, row_scale: torch.Tensor, size,
                       tile: int, rounds: int, tiles: torch.Tensor):
    """K5b's function in PyTorch: K4 scored as K3."""
    return _extract_tiles_plain(q8, corpus, size, tile, rounds,
                                tiles.long(), check_range=True,
                                row_scale=row_scale, q_scale=q_scale)


def packed_extract_scaled_plain(q: torch.Tensor, corpus: torch.Tensor,
                                row_scale: torch.Tensor, size, tile: int,
                                groups: int) -> torch.Tensor:
    """K2's function in PyTorch: K1's packed words [T, 2, B] of ``q``
    (already rounded to bf16, in f32) against the rows rounded to bf16,
    an f32 sum, ``* row_scale``."""
    return packed_extract_plain(q, corpus, size, tile, groups,
                                row_scale=row_scale,
                                rows_dtype=scaled_rows_dtype(corpus))


def extract_scaled_plain(q: torch.Tensor, corpus: torch.Tensor,
                         row_scale: torch.Tensor, size, tile: int,
                         rounds: int, tiles: torch.Tensor):
    """K5a's function in PyTorch: K4 scored as K2."""
    return _extract_tiles_plain(q, corpus, size, tile, rounds, tiles.long(),
                                check_range=True, row_scale=row_scale,
                                rows_dtype=scaled_rows_dtype(corpus))


def tile_topk_scaled_plain(q: torch.Tensor, corpus: torch.Tensor,
                           row_scale: torch.Tensor, size, tile: int,
                           tile_k: int):
    """K7's function in PyTorch: K6 scored as K2."""
    return _tile_topk_plain(q, corpus, size, tile, tile_k,
                            row_scale=row_scale,
                            rows_dtype=scaled_rows_dtype(corpus))


def scan_floor_plain(q: torch.Tensor, corpus: torch.Tensor,
                     tile: int) -> torch.Tensor:
    """F's function in PyTorch: f32 [T, 1, B], each tile's largest score
    of each query (every row counts)."""
    n, _ = corpus.shape
    b = q.shape[0]
    num_tiles = n // tile
    out = torch.empty((num_tiles, 1, b), dtype=torch.float32,
                      device=corpus.device)
    step = _tiles_per_block(b, tile)
    for t0 in range(0, num_tiles, step):
        t1 = min(num_tiles, t0 + step)
        s = _score(q, corpus[t0 * tile:t1 * tile]).view(b, t1 - t0, tile)
        out[t0:t1, 0] = s.amax(dim=-1).T
    return out


# ------------------------------------------------------------------ wrappers

def _scan_queries(queries: torch.Tensor, corpus: torch.Tensor):
    """Queries in the corpus dtype, widened back to float32."""
    return queries.to(corpus.dtype).float().contiguous()


def _bf16_queries(queries: torch.Tensor):
    """Queries rounded to bf16, in float32 (the scaled kernels' operand)."""
    return queries.to(torch.bfloat16).float().contiguous()


def _size_arg(size, n: int, device) -> torch.Tensor:
    """``size`` as a device int32 [1]; from an int by a fill kernel, so no
    host-to-device copy synchronises the stream."""
    if isinstance(size, torch.Tensor):
        return size.to(device=device, dtype=torch.int32).reshape(1)
    return torch.full((1,), n if size is None else int(size),
                      dtype=torch.int32, device=device)


def new_flag(device) -> torch.Tensor:
    """A cleared range flag (int32 [1]) for K1, K2 and K3 to set."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _flag_arg(flag, device) -> torch.Tensor:
    if flag is None:
        return new_flag(device)
    if (flag.dtype != torch.int32 or flag.numel() != 1
            or flag.device != device):
        raise ValueError(f"flag: {tuple(flag.shape)} {flag.dtype} on "
                         f"{flag.device}, want int32 [1] on {device}")
    return flag


_FLOAT_ROWS = (torch.float32, torch.bfloat16, torch.float16)
_SCALED_ROWS = _FLOAT_ROWS + (torch.int8,)
# Corpus dtype codes of the entry points (csrc/topk_common.cuh Dtype).
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int8: 3}


def _check_cuda(q: torch.Tensor, corpus: torch.Tensor, tile: int,
                dtypes=_FLOAT_ROWS, extract: bool = False) -> None:
    if corpus.device.type != "cuda":
        raise ValueError(f"no kernel for a corpus on {corpus.device}")
    if corpus.dtype not in dtypes:
        raise TypeError(f"corpus dtype {corpus.dtype}: this kernel takes "
                        f"{', '.join(str(t) for t in dtypes)}")
    if corpus.dim() != 2 or not corpus.is_contiguous():
        raise ValueError("corpus must be a contiguous [N, D] matrix")
    if q.dim() != 2 or q.shape[1] != corpus.shape[1] or q.shape[0] < 1:
        raise ValueError(f"queries {tuple(q.shape)} do not match corpus "
                         f"{tuple(corpus.shape)}")
    if q.device != corpus.device:
        raise ValueError("queries and corpus lie on different devices")
    n = corpus.shape[0]
    if tile < 128 or tile & (tile - 1) or n % tile:
        raise ValueError(f"tile={tile} must be a power of two >= 128 "
                         f"dividing N={n}")
    if extract and tile > MAX_EXTRACT_TILE:
        raise ValueError(f"tile={tile} exceeds {MAX_EXTRACT_TILE}, the "
                         "largest tile the selection kernels are held at")


def _check_groups(tile: int, groups: int) -> None:
    if groups < 1 or tile % groups:
        raise ValueError(f"tile={tile} must be a multiple of groups={groups}")
    if tile // groups > MAX_UNITS:
        raise ValueError(f"tile/groups={tile // groups} exceeds {MAX_UNITS}, "
                         "the most unit winners a block keeps in shared "
                         "memory")


# The widest rows (in features, rounded up to 16) the tensor-core scan sums
# in full accumulation: its truncation drifts one way, about a unit in the
# last place a k16 step (csrc/scan_mma.cuh).
MAX_FULL_ACCUMULATION_D = 640
# The widest int8 rows K3's int32 sums hold for any codes: 128 * 128 * D
# < 2**31.
MAX_INT8_D = 131_071
# The routes of the tensor-core packed scan's rounding rule: K1 ("dense"),
# K2 over bf16 rows ("scaled") and K2 over int8 codes ("codes").
SCAN_ROUTES = ("dense", "scaled", "codes")


def _row_norm_bound(d: int, route: str) -> float:
    """The largest norm of a row as the route scores it (K2: the row times
    its scale): 1 + 2**-8 (DenseIndex.add normalises rows), and for codes
    from ``quantize_int8`` the rounding of each code, up to half a scale
    of at most (1 + 2**-8)/127, on top: (1 + 2**-8)(1 + sqrt(D)/254)."""
    if route not in SCAN_ROUTES:
        raise ValueError(f"route {route!r}: one of {SCAN_ROUTES}")
    return (1.0 + 2.0 ** -8) * (1.0 + math.sqrt(d) / 254.0
                                if route == "codes" else 1.0)


def _scan_terms(d: int, route: str) -> tuple[float, int]:
    """(S_max, e) of csrc/scan_mma.cuh's argument: the largest sum of
    |products| (K2: times the row scale) a normalised query reaches on the
    route's rows, 1.01 times the rows' bound over 1 + 2**-8; and the
    roundings after the sum (K2's multiply by the row scale, once in the
    scan and once in the c1 rescore)."""
    s_max = 1.01 * _row_norm_bound(d, route) / (1.0 + 2.0 ** -8)
    return s_max, 0 if route == "dense" else 2


def scan_accumulation(tile: int | None, d: int,
                      route: str = "dense") -> str | None:
    """How K1 or K2 (``tile``) or F (``tile`` None) accumulates on the
    tensor cores at D: "full", "split" (each k16 step apart, then an f32
    sum), or None where neither bound on the tensor cores' rounding, plus
    the c1 rescore's, stays within one quantisation step of the
    certificate: S_max (units(D) + D + e) <= 4 tile (``_scan_terms``;
    ``route`` as ``SCAN_ROUTES``). Full only to D16 =
    ``MAX_FULL_ACCUMULATION_D``; F has no certificate (csrc/scan_mma.cuh,
    its header's argument). The one home of that rule: the wrappers pass
    the mode to the kernel."""
    d16 = (d + 15) // 16 * 16
    if tile is None:
        return "full" if d16 <= MAX_FULL_ACCUMULATION_D else "split"
    s_max, e = _scan_terms(d, route)
    quantum = 4.0 * tile
    if (d16 <= MAX_FULL_ACCUMULATION_D
            and s_max * (2.5 * d16 + d + e) <= quantum):
        return "full"
    if s_max * (40.0 + d16 / 16 + d + e) <= quantum:
        return "split"
    return None


def scan_rounding_units(d: int, mode: str) -> float:
    """delta(D) / (u S) of csrc/scan_mma.cuh's bound, u = 2**-24 and S the
    sum of |q_i c_i|: 2.5 D16 in full accumulation, 40 + D16/16 split."""
    d16 = (d + 15) // 16 * 16
    return 2.5 * d16 if mode == "full" else 40.0 + d16 / 16


def _covered(tile: int, d: int, route: str) -> str:
    """``scan_accumulation``'s mode; raises where it refuses."""
    mode = scan_accumulation(tile, d, route)
    if mode is None:
        raise ValueError(f"tile={tile}, D={d}: the tensor cores' rounding "
                         "could exceed the certificate's quantisation step "
                         "(csrc/scan_mma.cuh); use a larger tile")
    return mode


def scan_drift_bound(tile: int, d: int, route: str = "dense") -> float:
    """delta(D): the bound of csrc/scan_mma.cuh on |the scan's score - the
    exact score| of one K1 or K2 score over the route's normalised operands,
    at the accumulation ``scan_accumulation`` picks: S_max (units(D) +
    e/2) u, u = 2**-24 (K2's score is rounded once more, by its multiply by
    the row scale)."""
    s_max, e = _scan_terms(d, route)
    units = scan_rounding_units(d, _covered(tile, d, route))
    return s_max * (units + e / 2) * 2.0 ** -24


def scan_query_norm_limit(tile: int, d: int, route: str = "dense") -> float:
    """The largest query norm (as the scan rounds the query) for which the
    route's bound holds at (tile, D), against its rows
    (``_row_norm_bound``): S (units(D) + D + e) u <= one quantum, S <= |q|
    |row|."""
    units = scan_rounding_units(d, _covered(tile, d, route))
    s_max = 4.0 * tile / (units + d + _scan_terms(d, route)[1])
    return s_max / _row_norm_bound(d, route)


def _scan_route(corpus: torch.Tensor, scaled: bool) -> str | None:
    """The rounding rule's route of K1 (``scaled`` False) or K2 over this
    corpus on the card, None where the scan runs FMA on the CUDA cores (K1
    over f32 rows, K2 over f16 and f32 rows): the dispatch by dtype of
    csrc/packed_extract.cu."""
    if scaled:
        return {torch.int8: "codes",
                torch.bfloat16: "scaled"}.get(corpus.dtype)
    return None if corpus.dtype == torch.float32 else "dense"


def _scan_split(route: str | None, tile: int, d: int) -> int:
    """The tensor-core scan's accumulation (1 split, 0 full); raises at
    (tile, D) pairs its bound does not cover. FMA (route None): 0."""
    return 0 if route is None else int(_covered(tile, d, route) == "split")


def _flag_wide_queries(flag: torch.Tensor, q: torch.Tensor, tile: int,
                       route: str) -> None:
    """Set the range flag where a query's norm exceeds what the route's
    rounding bound admits (``scan_query_norm_limit``), on the card without
    a host sync."""
    limit = scan_query_norm_limit(tile, q.shape[1], route)
    flag.bitwise_or_((q.square().sum(1).amax() > limit * limit)
                     .to(torch.int32))


def _scan_operands(q: torch.Tensor, dtype, tensor_cores: bool):
    """(qT, qh): the scan queries (already rounded to ``dtype``) as the
    kernel takes them, the other None: [D, B] f32 for the FMA kernels, or
    [B, D] as ``dtype`` values (exact) for the tensor-core scan."""
    if tensor_cores:
        return None, q.to(dtype).contiguous()
    return q.T.contiguous(), None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_rounds(rounds: int, tile: int, what: str = "rounds") -> None:
    if not 1 <= rounds <= tile:
        raise ValueError(f"{what}={rounds} outside [1, tile={tile}]")


def _check_scales(corpus: torch.Tensor, row_scale: torch.Tensor,
                  q8: torch.Tensor | None = None,
                  q_scale: torch.Tensor | None = None) -> None:
    """The int8 and scaled kernels' extra operands: f32 row scales [N]; for
    the int8-native ones, int8 query codes [B, D] and f32 query scales
    [B]."""
    n, d = corpus.shape
    checks = [(row_scale, (n,), torch.float32, "row_scale")]
    if q8 is not None:
        checks += [(q8, (q8.shape[0], d), torch.int8, "query codes"),
                   (q_scale, (q8.shape[0],), torch.float32, "q_scale")]
    for t, shape, dtype, what in checks:
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != corpus.device):
            raise ValueError(f"{what}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {shape} {dtype} on "
                             f"{corpus.device}")


def _launch(name: str, fn, corpus: torch.Tensor, *args) -> None:
    from optimized_rag_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.orag_error_string(err).decode()}")
    if name in _launches:
        with _counts_lock:
            _launches[name] += 1


def packed_extract(queries: torch.Tensor, corpus: torch.Tensor, size,
                   tile: int, groups: int = 8, flag=None) -> torch.Tensor:
    """Per-tile top-2 packed unit winners, int32 [T, 2, B] (the bits
    ``_packed_pass`` returns as float32). ``flag`` (int32 [1], on the card)
    is set to 1 when a live score lies outside (-2, 2), and over bf16/f16
    rows also when a query's norm exceeds ``scan_query_norm_limit``: the
    tensor-core scan's rounding bound needs normalised queries and rows of
    norm at most 1 + 2**-8."""
    q = _scan_queries(queries, corpus)
    if corpus.device.type == "cpu":
        return packed_extract_plain(q, corpus, size, tile, groups)
    _check_cuda(q, corpus, tile)
    _check_groups(tile, groups)
    n, d = corpus.shape
    route = _scan_route(corpus, scaled=False)
    split = _scan_split(route, tile, d)
    b = q.shape[0]
    qT, qh = _scan_operands(q, corpus.dtype, route is not None)
    size_t = _size_arg(size, n, corpus.device)
    flag_t = _flag_arg(flag, corpus.device)
    if route is not None:
        _flag_wide_queries(flag_t, q, tile, route)
    out = torch.empty((n // tile, 2, b), dtype=torch.int32,
                      device=corpus.device)
    _launch("packed_extract", "orag_packed_extract", corpus, _ptr(qT),
            _ptr(qh), corpus.data_ptr(),
            _DTYPE_CODE[corpus.dtype], size_t.data_ptr(), out.data_ptr(),
            flag_t.data_ptr(), b, n, d, tile, groups, split)
    return out


def extract(queries: torch.Tensor, corpus: torch.Tensor, size, tile: int,
            rounds: int, tiles: torch.Tensor):
    """Exact top-``rounds`` rows of each listed tile: (val f32, col int32
    tile-local), each [U, rounds, B]."""
    q = _scan_queries(queries, corpus)
    if corpus.device.type == "cpu":
        return extract_plain(q, corpus, size, tile, rounds, tiles)
    _check_cuda(q, corpus, tile, extract=True)
    _check_rounds(rounds, tile)
    tiles = tiles.to(device=corpus.device, dtype=torch.int32).contiguous()
    n, d = corpus.shape
    b, u = q.shape[0], tiles.shape[0]
    qT = q.T.contiguous()
    size_t = _size_arg(size, n, corpus.device)
    val = torch.empty((u, rounds, b), dtype=torch.float32,
                      device=corpus.device)
    col = torch.empty((u, rounds, b), dtype=torch.int32, device=corpus.device)
    _launch("extract", "orag_extract", corpus, qT.data_ptr(),
            corpus.data_ptr(), _DTYPE_CODE[corpus.dtype], size_t.data_ptr(),
            tiles.data_ptr(), u, val.data_ptr(), col.data_ptr(), b, n, d,
            tile, rounds)
    return val, col


def tile_topk(queries: torch.Tensor, corpus: torch.Tensor, size, tile: int,
              tile_k: int):
    """Per-tile top-``tile_k``: (s f32, i int32 global ids), each
    [T, tile_k, B]."""
    q = _scan_queries(queries, corpus)
    if corpus.device.type == "cpu":
        return tile_topk_plain(q, corpus, size, tile, tile_k)
    _check_cuda(q, corpus, tile, extract=True)
    _check_rounds(tile_k, tile, "tile_k")
    n, d = corpus.shape
    b = q.shape[0]
    qT = q.T.contiguous()
    size_t = _size_arg(size, n, corpus.device)
    s = torch.empty((n // tile, tile_k, b), dtype=torch.float32,
                    device=corpus.device)
    i = torch.empty((n // tile, tile_k, b), dtype=torch.int32,
                    device=corpus.device)
    _launch("tile_topk", "orag_tile_topk", corpus, qT.data_ptr(),
            corpus.data_ptr(), _DTYPE_CODE[corpus.dtype], size_t.data_ptr(),
            s.data_ptr(), i.data_ptr(), b, n, d, tile, tile_k)
    return s, i


def _int8_words(q8: torch.Tensor) -> torch.Tensor:
    """Query codes [B, D] as int32 words of 4 codes (zero codes past D),
    transposed [ceil(D/4), B]."""
    pad = (-q8.shape[1]) % 4
    q8 = torch.nn.functional.pad(q8, (0, pad)) if pad else q8.contiguous()
    return q8.view(torch.int32).T.contiguous()


def packed_extract_int8(q8: torch.Tensor, q_scale: torch.Tensor,
                        corpus: torch.Tensor, row_scale: torch.Tensor, size,
                        tile: int, groups: int = 8,
                        flag=None) -> torch.Tensor:
    """K3: K1's packed words [T, 2, B] of int8 codes ``q8`` [B, D] (scales
    ``q_scale`` [B]) against an int8 corpus (scales ``row_scale`` [N]). On
    the card the codes go to the tensor cores as they are (K-major [B, D]);
    the int32 sums are exact up to D = ``MAX_INT8_D``."""
    if corpus.device.type == "cpu":
        return packed_extract_int8_plain(q8, q_scale, corpus, row_scale,
                                         size, tile, groups)
    _check_cuda(q8, corpus, tile, dtypes=(torch.int8,))
    _check_scales(corpus, row_scale, q8, q_scale)
    _check_groups(tile, groups)
    n, d = corpus.shape
    if d > MAX_INT8_D:
        raise ValueError(f"D={d} exceeds {MAX_INT8_D}: int8 sums could "
                         "overflow int32")
    b = q8.shape[0]
    # Operands stay bound to names until the launch is enqueued: a freed
    # temporary could be reallocated by another thread first.
    q8c, qs, cs = (q8.contiguous(), q_scale.contiguous(),
                   row_scale.contiguous())
    size_t = _size_arg(size, n, corpus.device)
    flag_t = _flag_arg(flag, corpus.device)
    out = torch.empty((n // tile, 2, b), dtype=torch.int32,
                      device=corpus.device)
    _launch("packed_extract_int8", "orag_packed_extract_int8", corpus,
            q8c.data_ptr(), qs.data_ptr(), corpus.data_ptr(), cs.data_ptr(),
            size_t.data_ptr(), out.data_ptr(), flag_t.data_ptr(), b, n, d,
            tile, groups)
    return out


def extract_int8(q8: torch.Tensor, q_scale: torch.Tensor,
                 corpus: torch.Tensor, row_scale: torch.Tensor, size,
                 tile: int, rounds: int, tiles: torch.Tensor):
    """K5b: ``extract`` scored as K3: (val f32, col int32 tile-local),
    each [U, rounds, B]."""
    if corpus.device.type == "cpu":
        return extract_int8_plain(q8, q_scale, corpus, row_scale, size, tile,
                                  rounds, tiles)
    _check_cuda(q8, corpus, tile, dtypes=(torch.int8,), extract=True)
    _check_scales(corpus, row_scale, q8, q_scale)
    _check_rounds(rounds, tile)
    tiles = tiles.to(device=corpus.device, dtype=torch.int32).contiguous()
    n, d = corpus.shape
    b, u = q8.shape[0], tiles.shape[0]
    qwT, qs, cs = _int8_words(q8), q_scale.contiguous(), row_scale.contiguous()
    size_t = _size_arg(size, n, corpus.device)
    val = torch.empty((u, rounds, b), dtype=torch.float32,
                      device=corpus.device)
    col = torch.empty((u, rounds, b), dtype=torch.int32, device=corpus.device)
    _launch("extract_int8", "orag_extract_int8", corpus, qwT.data_ptr(),
            qs.data_ptr(), corpus.data_ptr(), cs.data_ptr(),
            size_t.data_ptr(), tiles.data_ptr(), u, val.data_ptr(),
            col.data_ptr(), b, n, d, tile, rounds)
    return val, col


def packed_extract_scaled(queries: torch.Tensor, corpus: torch.Tensor,
                          row_scale: torch.Tensor, size, tile: int,
                          groups: int = 8, flag=None) -> torch.Tensor:
    """K2: K1's packed words [T, 2, B] of the queries rounded to bf16
    against the rows rounded to bf16 (int8 codes, or float rows), an f32
    sum, ``* row_scale`` [N]. Over int8 codes and bf16 rows on the card the
    tensor cores sum (``scan_accumulation``'s "codes" and "scaled" routes:
    it raises at (tile, D) pairs their bound does not cover, and ``flag``
    is also set where a query's norm exceeds ``scan_query_norm_limit``);
    over f16 and f32 rows f32 FMA."""
    q = _bf16_queries(queries)
    if corpus.device.type == "cpu":
        return packed_extract_scaled_plain(q, corpus, row_scale, size, tile,
                                           groups)
    _check_cuda(q, corpus, tile, dtypes=_SCALED_ROWS)
    _check_scales(corpus, row_scale)
    _check_groups(tile, groups)
    n, d = corpus.shape
    route = _scan_route(corpus, scaled=True)
    split = _scan_split(route, tile, d)
    b = q.shape[0]
    qT, qh = _scan_operands(q, torch.bfloat16, route is not None)
    cs = row_scale.contiguous()
    size_t = _size_arg(size, n, corpus.device)
    flag_t = _flag_arg(flag, corpus.device)
    if route is not None:
        _flag_wide_queries(flag_t, q, tile, route)
    out = torch.empty((n // tile, 2, b), dtype=torch.int32,
                      device=corpus.device)
    _launch("packed_extract_scaled", "orag_packed_extract_scaled", corpus,
            _ptr(qT), _ptr(qh), corpus.data_ptr(),
            _DTYPE_CODE[corpus.dtype], cs.data_ptr(), size_t.data_ptr(),
            out.data_ptr(), flag_t.data_ptr(), b, n, d, tile, groups, split)
    return out


def extract_scaled(queries: torch.Tensor, corpus: torch.Tensor,
                   row_scale: torch.Tensor, size, tile: int, rounds: int,
                   tiles: torch.Tensor):
    """K5a: ``extract`` scored as K2: (val f32, col int32 tile-local),
    each [U, rounds, B]."""
    q = _bf16_queries(queries)
    if corpus.device.type == "cpu":
        return extract_scaled_plain(q, corpus, row_scale, size, tile, rounds,
                                    tiles)
    _check_cuda(q, corpus, tile, dtypes=_SCALED_ROWS, extract=True)
    _check_scales(corpus, row_scale)
    _check_rounds(rounds, tile)
    tiles = tiles.to(device=corpus.device, dtype=torch.int32).contiguous()
    n, d = corpus.shape
    b, u = q.shape[0], tiles.shape[0]
    qT, cs = q.T.contiguous(), row_scale.contiguous()
    size_t = _size_arg(size, n, corpus.device)
    val = torch.empty((u, rounds, b), dtype=torch.float32,
                      device=corpus.device)
    col = torch.empty((u, rounds, b), dtype=torch.int32, device=corpus.device)
    _launch("extract_scaled", "orag_extract_scaled", corpus, qT.data_ptr(),
            corpus.data_ptr(), _DTYPE_CODE[corpus.dtype], cs.data_ptr(),
            size_t.data_ptr(), tiles.data_ptr(), u, val.data_ptr(),
            col.data_ptr(), b, n, d, tile, rounds)
    return val, col


def tile_topk_scaled(queries: torch.Tensor, corpus: torch.Tensor,
                     row_scale: torch.Tensor, size, tile: int, tile_k: int):
    """K7: per-tile top-``tile_k`` scored as K2: (s f32, i int32 global
    ids), each [T, tile_k, B]."""
    q = _bf16_queries(queries)
    if corpus.device.type == "cpu":
        return tile_topk_scaled_plain(q, corpus, row_scale, size, tile,
                                      tile_k)
    _check_cuda(q, corpus, tile, dtypes=_SCALED_ROWS, extract=True)
    _check_scales(corpus, row_scale)
    _check_rounds(tile_k, tile, "tile_k")
    n, d = corpus.shape
    b = q.shape[0]
    qT, cs = q.T.contiguous(), row_scale.contiguous()
    size_t = _size_arg(size, n, corpus.device)
    s = torch.empty((n // tile, tile_k, b), dtype=torch.float32,
                    device=corpus.device)
    i = torch.empty((n // tile, tile_k, b), dtype=torch.int32,
                    device=corpus.device)
    _launch("tile_topk_scaled", "orag_tile_topk_scaled", corpus,
            qT.data_ptr(), corpus.data_ptr(), _DTYPE_CODE[corpus.dtype],
            cs.data_ptr(), size_t.data_ptr(), s.data_ptr(), i.data_ptr(), b,
            n, d, tile, tile_k)
    return s, i


def scan_floor(queries: torch.Tensor, corpus: torch.Tensor,
               tile: int) -> torch.Tensor:
    """F: each tile's largest score of each query, f32 [T, 1, B], the
    queries cast to the corpus dtype (the scan's speed floor)."""
    q = _scan_queries(queries, corpus)
    if corpus.device.type == "cpu":
        return scan_floor_plain(q, corpus, tile)
    _check_cuda(q, corpus, tile)
    n, d = corpus.shape
    b = q.shape[0]
    qT, qh = _scan_operands(q, corpus.dtype,
                            corpus.dtype != torch.float32)
    split = int(qh is not None and scan_accumulation(None, d) == "split")
    out = torch.empty((n // tile, 1, b), dtype=torch.float32,
                      device=corpus.device)
    _launch("scan_floor", "orag_scan_floor", corpus, _ptr(qT), _ptr(qh),
            corpus.data_ptr(), _DTYPE_CODE[corpus.dtype], out.data_ptr(), b,
            n, d, tile, split)
    return out


def scan_sums_plain(q: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Twin of ``scan_sums``: f32 [N, B], torch.matmul in float32."""
    return (corpus.float() @ q.T).contiguous()


def scan_sums(queries: torch.Tensor, corpus: torch.Tensor, tile: int,
              split: bool = False) -> torch.Tensor:
    """The tensor-core scan's raw f32 sums [N, B], in full or split
    accumulation: over bf16/f16 rows the main loop of K1 and F, over int8
    codes K2's (the queries rounded to bf16, the codes widened to bf16),
    with a store epilogue, for holding its rounding to csrc/scan_mma.cuh's
    bound (no launch count: no search path runs it). ``tile`` only sets the
    grid."""
    codes = corpus.dtype == torch.int8
    q = _bf16_queries(queries) if codes else _scan_queries(queries, corpus)
    if corpus.device.type == "cpu":
        return scan_sums_plain(q, corpus)
    _check_cuda(q, corpus, tile,
                dtypes=(torch.bfloat16, torch.float16, torch.int8))
    n, d = corpus.shape
    b = q.shape[0]
    qh = q.to(torch.bfloat16 if codes else corpus.dtype).contiguous()
    out = torch.empty((n, b), dtype=torch.float32, device=corpus.device)
    _launch("scan_sums", "orag_scan_sums", corpus, qh.data_ptr(),
            corpus.data_ptr(), _DTYPE_CODE[corpus.dtype], out.data_ptr(), b,
            n, d, tile, int(split))
    return out
