"""Dense top-k retrieval: exact scans, the tiled kernel search, the
verified searches, and the certified packed search with its ANN variant.

Held against ``optimized_rag_tpu/ops/topk.py`` (:38-135, :198-475,
:697-989, :1144-1340). Every function returns ``(scores [B, k] f32,
ids [B, k])``; the certified ones and ``topk_verified_batch`` append the
certificate row to ids. Ties go to the lower index everywhere, as
``lax.top_k`` and ``jnp.argmax`` give them: ``torch.topk`` promises no tie
order, so every selection here is a stable descending sort over candidates
in row order (``_topk_rows`` puts them in row order where they come in
another). The JAX certified, verified and ANN paths and ``rescore_topk``
order exact ties by candidate rank instead; here they take the lower row,
as every other path does.

All float32 products run in full float32 (``device.configure_numerics``
turns TF32 off): the certificate's two-step cushion (``_unpack_ub``) allows
for reduction-order drift between the scan and the covers, not for TF32.

Corpora with a ``row_scale`` [N] (ops/quantize.py): the plain scans and
``rescore_topk`` dequantize; ``tiled_topk`` runs K7 (bf16 query x rows
rounded to bf16, x row scale). ``topk_certified`` on an int8 corpus runs
int8-native (``int8_native=True``): the queries are quantized, K3 scans
and K5b covers, and the scores ``(float(i32) * row_scale) * q_scale``,
exact at any width, are what its c1 rescore repeats bit for bit. With
``int8_native=False``, or a ``row_scale`` on a float corpus, it runs the
scaled route: K2 scans and K5a covers, scoring bf16(q) x bf16(row) in f32
times the row scale, which c1 rescores.

The certified path needs every score in (-2, 2). On the CPU the kernels'
twins raise ``ValueError``; on the card K1/K2/K3 set a flag that turns the
certificate to -1, and ``certificate_uncovered`` (where every caller reads
the certificate) raises the same error. ``topk_ann`` has no certificate: it
reads the flag itself, one device-to-host copy a call.

A nonzero certificate is settled by ``repair_uncovered``: the covers'
state (``Cover``) names every (query, tile) pair they left unproven, K4p
takes each such tile's exact top-k for its query, and the merge is the
exact answer for the certified path's scoring; the reference reruns the
tiled search instead, as ``repair_uncovered`` still does where the pairs
would cost more than the rerun.

Not ported: ``tile_k``-approximate extraction beyond ``dispatch_topk``'s
``approx_tile_k`` opt-in.
"""

from __future__ import annotations

import dataclasses

import torch

from optimized_rag_tpu_torch.ops.quantize import quantize_int8
from optimized_rag_tpu_torch.ops.topk_kernels import (
    _EXACT_CODES, NEG_INF, RANGE_ERROR, SELECTION_QUERY_BLOCK, extract,
    extract_int8, extract_pairs, extract_scaled, new_flag, packed_extract,
    packed_extract_int8, packed_extract_scaled, scaled_rows_dtype, tile_topk,
    tile_topk_scaled)


def _topk(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_rows(scores: torch.Tensor, rows: torch.Tensor, k: int):
    """Top-k of ``scores`` [B, M] and their row ids ``rows`` [B, M], exact
    ties to the lower row id whatever order the candidates come in."""
    by_row = torch.argsort(rows, dim=-1, stable=True)
    top_s, pos = _topk(torch.gather(scores, -1, by_row), k)
    return top_s, torch.gather(torch.gather(rows, -1, by_row), -1, pos)


def _mask_padding(scores: torch.Tensor, base: int, size) -> torch.Tensor:
    col = torch.arange(scores.shape[-1], device=scores.device) + base
    return torch.where(col < size, scores, NEG_INF)


def exact_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
               size=None, row_scale=None):
    """Brute-force matmul + top-k. queries [B, D], corpus [N, D];
    ``row_scale`` [N] dequantizes an int8 corpus's scores."""
    scores = queries.float() @ corpus.float().T
    if row_scale is not None:
        scores = scores * row_scale[None, :].float()
    if size is not None:
        scores = _mask_padding(scores, 0, size)
    return _topk(scores, k)


def chunked_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                 size=None, chunk: int = 65536, row_scale=None):
    """Streaming top-k over corpus chunks, memory O(B*(chunk+k)); a
    remainder tail of ``n % chunk`` rows is scored as one more chunk.
    ``row_scale`` [N] dequantizes each chunk's scores."""
    n = corpus.shape[0]
    b = queries.shape[0]
    q = queries.float()
    dev = corpus.device
    size_ = n if size is None else size
    best_s = torch.full((b, k), NEG_INF, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.long, device=dev)
    for base in range(0, n, chunk):
        rows = corpus[base:base + chunk]
        s = q @ rows.float().T
        if row_scale is not None:
            s = s * row_scale[base:base + chunk][None, :].float()
        s = _mask_padding(s, base, size_)
        col = torch.arange(base, base + rows.shape[0], device=dev)
        cand_s = torch.cat([best_s, s], dim=1)
        cand_i = torch.cat([best_i, col.expand(b, -1)], dim=1)
        best_s, pos = _topk(cand_s, k)
        best_i = torch.gather(cand_i, 1, pos)
    return best_s, best_i


def _merge_tile_winners(tile_s: torch.Tensor, tile_i: torch.Tensor, k: int):
    """Merge [T, tile_k, B] tile winners into the top-k of [B, T*tile_k]."""
    t, tile_k, b = tile_s.shape
    cand_s = tile_s.permute(2, 0, 1).reshape(b, t * tile_k)
    cand_i = tile_i.permute(2, 0, 1).reshape(b, t * tile_k)
    top_s, pos = _topk(cand_s, k)
    return top_s, torch.gather(cand_i, 1, pos).long()


def tiled_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
               size=None, tile: int = 1024, tile_k: int | None = None,
               row_scale=None):
    """Exact two-stage top-k: per-tile top-``tile_k`` (kernel K6, or K7
    with ``row_scale``) then a merge. Ports ``pallas_topk``.
    ``tile_k < k`` is approximate."""
    n = corpus.shape[0]
    assert k <= tile
    tile_k = min(tile_k or k, k)
    assert (n // tile) * tile_k >= k, (n // tile, tile_k, k)
    if row_scale is None:
        tile_s, tile_i = tile_topk(queries, corpus, size, tile, tile_k)
    else:
        tile_s, tile_i = tile_topk_scaled(queries, corpus, row_scale, size,
                                          tile, tile_k)
    return _merge_tile_winners(tile_s, tile_i, k)


def _exact_rowwise_scores(queries: torch.Tensor, gathered: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    """Per-query scores against per-query gathered rows [B, M, D] -> [B, M],
    scoring the kernels' function: queries cast to ``dtype``, both operands
    widened to float32 (bf16 and f16 values are exact in f32), f32
    products."""
    q = queries.to(dtype).float()
    return torch.bmm(gathered.float(), q[:, :, None])[:, :, 0]


def _exact_rowwise_scores_int8(q8: torch.Tensor, gathered: torch.Tensor,
                                row_scale: torch.Tensor,
                                q_scale: torch.Tensor) -> torch.Tensor:
    """The int8-native score of per-query gathered rows [B, M, D] -> [B, M]:
    the exact int32 code dot (float32 products of at most 1040 codes, each
    an exact integer, added in int32), then the kernels' multiply order,
    ``(float(i32) * row_scale) * q_scale``."""
    raw = None
    for lo in range(0, q8.shape[1], _EXACT_CODES):
        hi = lo + _EXACT_CODES
        part = torch.bmm(gathered[..., lo:hi].float(),
                         q8[:, lo:hi].float()[:, :, None])[:, :, 0]
        raw = (part.to(torch.int32) if raw is None
               else raw + part.to(torch.int32))
    return (raw.float() * row_scale) * q_scale[:, None]


def _exact_rowwise_scores_scaled(queries: torch.Tensor,
                                 gathered: torch.Tensor,
                                 row_scale: torch.Tensor) -> torch.Tensor:
    """The scaled route's score of gathered rows [B, M, D] -> [B, M]: the
    queries and rows rounded to bf16, f32 products, then ``* row_scale``
    [B, M] (K2, K5a and K7's function)."""
    rows_dtype = scaled_rows_dtype(gathered)
    rows = gathered if rows_dtype is None else gathered.to(rows_dtype)
    return _exact_rowwise_scores(queries, rows, torch.bfloat16) * row_scale


def _unpack_lb(vals: torch.Tensor, tile: int) -> torch.Tensor:
    """Quantised lower bound of the score from a packed int32."""
    return (vals & -tile).view(torch.float32) - 2.0


def _unpack_ub(vals: torch.Tensor, tile: int) -> torch.Tensor:
    """Upper bound: one quantisation step, plus one step of cushion for
    reduction-order drift between the scan and the rescore."""
    return ((vals & -tile) + 2 * tile).view(torch.float32) - 2.0


def _certificate_row(uncovered, flag: torch.Tensor, k: int) -> torch.Tensor:
    """The certificate row [1, k]: ``uncovered`` in its first slot, or -1
    when the range flag is set (a live score outside (-2, 2))."""
    row = torch.zeros((1, k), dtype=torch.long, device=flag.device)
    row[0, 0] = torch.where(flag[0] > 0, -1, uncovered)
    return row


def _duplicates(rows: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """[B, M] bool: ok entries whose row already appears at an earlier ok
    entry of the same query (every copy scores alike: one is kept)."""
    m = rows.shape[1]
    key = torch.where(ok, rows, -2 - torch.arange(m, device=rows.device))
    srt, order = torch.sort(key, dim=1, stable=True)
    dup_sorted = torch.zeros_like(ok)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    return torch.zeros_like(ok).scatter(1, order, dup_sorted)


@dataclasses.dataclass
class Cover:
    """What the certified covers leave to repair. ``need`` [B, T] bool: the
    (query, tile) pairs outside the union whose rows the covers did not
    prove below tau: c2's (the tile's second unit may beat tau) and, for a
    c3 query (its best excluded candidate may beat tau), every tile whose
    best unit may beat tau and was not rescored by c1. ``mode`` is the
    scoring: "dense" (K4's), "scaled" (K5a's) or "native" (K5b's)."""
    need: torch.Tensor
    mode: str


def _packed_search(queries, corpus, k, size, tile, groups, union_tiles,
                   pad_r, row_scale, int8_native, covers):
    """``pallas_topk_certified`` with its ``covers`` switch: the packed
    scan, c1's unit-expanded exact rescore and, with ``covers``, the c2/c3
    covers and the certificate row; without, the ANN answer (c1 alone,
    with +-4 column windows). Returns (scores, ids, range flag, the covers'
    ``Cover`` or None)."""
    n, d = corpus.shape
    b = queries.shape[0]
    dev = corpus.device
    small = tile // groups
    num_tiles = n // tile
    assert 2 * num_tiles > k, (num_tiles, k)
    size_ = n if size is None else size
    mode = ("dense" if row_scale is None
            else "native" if corpus.dtype == torch.int8 and int8_native
            else "scaled")
    flag = new_flag(dev)
    if mode == "native":
        q8, q_scale = quantize_int8(queries)
        w_val = packed_extract_int8(q8, q_scale, corpus, row_scale, size,
                                    tile, groups, flag)          # [T, 2, B]
    elif mode == "scaled":
        w_val = packed_extract_scaled(queries, corpus, row_scale, size, tile,
                                      groups, flag)
    else:
        w_val = packed_extract(queries, corpus, size, tile, groups, flag)

    vals = w_val.permute(2, 0, 1).reshape(b, 2 * num_tiles)
    cand_tile = torch.arange(2 * num_tiles, device=dev) // 2
    rows = cand_tile[None, :] * tile + (vals & (tile - 1)).long()
    r_cnt = pad_r or min(k + max(k, 8), 2 * num_tiles - 1)
    assert r_cnt * groups >= k and r_cnt < 2 * num_tiles
    vtop, vpos = _topk(vals, r_cnt + 1)
    sel_rows = torch.gather(rows, 1, vpos)

    # c1: exact rescore of the top-R candidates plus their full units.
    r_rows = sel_rows[:, :r_cnt]
    r_tile = r_rows // tile
    r_unit = (r_rows - r_tile * tile) % small
    members = (r_tile[:, :, None] * tile + r_unit[:, :, None]
               + (torch.arange(groups, device=dev) * small)[None, None, :])
    ukey = r_tile * small + r_unit
    ridx = torch.arange(r_cnt, device=dev)
    dup = ((ukey[:, :, None] == ukey[:, None, :])
           & (ridx[None, :, None] > ridx[None, None, :])).any(dim=2)
    valid_cand = (vtop[:, :r_cnt] > 0) & ~dup
    if not covers:
        # ANN: each candidate's +-4 column window rides the rescore too, so
        # contiguous same-document runs inside one tile surface; windows
        # overlap, so duplicate rows are dropped.
        offs = torch.cat([torch.arange(-4, 0, device=dev),
                          torch.arange(1, 5, device=dev)])
        win = (r_rows[:, :, None] + offs[None, None, :]).clamp(0, n - 1)
        members = torch.cat([members, win], dim=2)
    flat = members.reshape(b, -1)
    okf = (valid_cand[:, :, None] & (members < size_)).reshape(b, -1)
    if not covers:
        okf = okf & ~_duplicates(flat, okf)
    safe = flat.clamp_min(0)
    gathered = corpus[safe]                                       # [B, M, D]
    if mode == "native":
        sc = _exact_rowwise_scores_int8(q8, gathered, row_scale[safe],
                                        q_scale)
    elif mode == "scaled":
        sc = _exact_rowwise_scores_scaled(queries, gathered, row_scale[safe])
    else:
        sc = _exact_rowwise_scores(queries, gathered, corpus.dtype)
    sc = torch.where(okf, sc, NEG_INF)
    top_s, top_i = _topk_rows(sc, flat, k)
    if not covers:
        return top_s, torch.where(top_s > NEG_INF / 2, top_i, -1), flag, None
    tau = top_s[:, k - 1]

    # c3: the best excluded candidate must be provably below tau.
    c3_viol = _unpack_ub(vtop[:, r_cnt], tile) > tau

    # c2: tiles whose second unit may beat tau, covered by the exact
    # per-tile top-k of the union (K4, K5a or K5b).
    u = min(union_tiles, num_tiles)
    ub2 = _unpack_ub(w_val[:, 1, :], tile).T                       # [B, T]
    sus = ub2 > tau[:, None]
    priority = torch.where(sus, ub2 - tau[:, None],
                           float("-inf")).amax(dim=0)             # [T]
    sel_pri, sel_tiles = _topk(priority, u)
    sel_valid = sel_pri > float("-inf")
    selected = torch.zeros(num_tiles, dtype=torch.bool, device=dev)
    selected[sel_tiles] = sel_valid
    uncovered = (sus & ~selected[None, :]).sum() + c3_viol.sum()
    # The pairs a repair must read (Cover). A tile outside the union and
    # not c2's holds rows above its second unit's bound only in its best
    # unit, which c1 rescored whole where that word was among its top R.
    ub1 = _unpack_ub(w_val[:, 0, :], tile).T                       # [B, T]
    rescored = torch.zeros((b, 2 * num_tiles), dtype=torch.bool,
                           device=dev).scatter_(1, vpos[:, :r_cnt], True)
    best_open = (ub1 > tau[:, None]) & ~rescored.view(b, num_tiles, 2)[..., 0]
    need = (sus | (c3_viol[:, None] & best_open)) & ~selected[None, :]
    tiles32 = sel_tiles.to(torch.int32)
    if mode == "native":
        uval, ucol = extract_int8(q8, q_scale, corpus, row_scale, size,
                                  tile, k, tiles32)
    elif mode == "scaled":
        uval, ucol = extract_scaled(queries, corpus, row_scale, size, tile,
                                    k, tiles32)
    else:
        uval, ucol = extract(queries, corpus, size, tile, k, tiles32)
    uc = torch.where(sel_valid[None, :, None], uval.permute(2, 0, 1),
                     NEG_INF)                                     # [B, U, k]
    urow = (sel_tiles[:, None, None] * tile + ucol.long()).permute(2, 0, 1)
    r_s, r_i = _topk_rows(uc.reshape(b, u * k), urow.reshape(b, u * k), k)

    # Rows of selected tiles are re-found by the union pass: mask the c1
    # copy instead of deduplicating ids.
    in_sel = selected[(top_i // tile).clamp(0, num_tiles - 1)]
    m_s = torch.cat([torch.where(in_sel, NEG_INF, top_s), r_s], dim=1)
    m_i = torch.cat([top_i, r_i], dim=1)
    out_s, out_i = _topk_rows(m_s, m_i, k)
    return (out_s, torch.cat([out_i, _certificate_row(uncovered, flag, k)]),
            flag, Cover(need, mode))


def topk_certified(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                   size=None, tile: int = 4096, groups: int = 8,
                   union_tiles: int = 32, pad_r: int | None = None,
                   row_scale=None, int8_native: bool = True):
    """EXACT top-k by the packed scan (K1) plus three certified covers.
    Ports ``pallas_topk_certified``.

    queries [B, D] normalised (scores in (-2, 2)); corpus [N, D] with
    N % tile == 0 and 2*(N/tile) > k. Over bf16/f16 rows on the card the
    scan keeps the tensor cores' sums, whose rounding bound
    (csrc/scan_mma.cuh) needs rows of norm at most 1 + 2**-8, as
    ``DenseIndex.add`` makes them, and queries within
    ``topk_kernels.scan_query_norm_limit`` (checked on the card); so does
    the scaled route over int8 codes (``quantize_int8`` of such rows) and
    over bf16 rows (whose scaled values have such norms). Returns
    (scores [B, k] f32, ids [B+1, k] int64) with ids[B, 0] the uncovered
    count: 0 means exact for the scan's scoring; otherwise rerun with
    ``tiled_topk`` (``dispatch_topk`` repairs the uncovered pairs
    instead). Read it with ``certificate_uncovered``, which raises when a
    live score lay outside (-2, 2) or a query's norm past that limit (the
    count then reads -1).

    c1 rescored exactly the top-R candidates with their full strided units;
    c2 takes the exact per-tile top-k (K4) of the union of tiles whose
    second unit may beat tau; c3 checks the best excluded candidate.

    ``row_scale`` [N]: on an int8 corpus with ``int8_native`` the queries
    are quantized on their device (ops/quantize.py), K3 scans and K5b
    covers, and every score is ``(float(i32) * row_scale) * q_scale``;
    otherwise (``int8_native=False``, or a float corpus) the scaled route
    scores bf16(q) x bf16(row) in f32 times the row scale, K2 scanning and
    K5a covering. The certificate means exact for that scoring.
    """
    s, ids, _, _ = _packed_search(queries, corpus, k, size, tile, groups,
                                  union_tiles, pad_r, row_scale, int8_native,
                                  covers=True)
    return s, ids


def _certified(queries, corpus, k, size=None, sub_batch=1024, tile=4096,
               groups=8, union_tiles=32, pad_r=None, row_scale=None,
               int8_native=True):
    """``topk_certified_multi`` with the covers' state: (scores, ids with
    the certificate row, the whole batch's ``Cover``)."""
    mb = queries.shape[0]
    assert mb % sub_batch == 0, (mb, sub_batch)
    blocks = [_packed_search(queries[s0:s0 + sub_batch], corpus, k, size,
                             tile, groups, union_tiles, pad_r, row_scale,
                             int8_native, covers=True)
              for s0 in range(0, mb, sub_batch)]
    if len(blocks) == 1:
        s, ids, _, cover = blocks[0]
        return s, ids, cover
    counts = torch.stack([i[-1, 0] for _, i, _, _ in blocks])
    count_row = torch.zeros((1, k), dtype=torch.long, device=corpus.device)
    count_row[0, 0] = torch.where((counts < 0).any(), -1, counts.sum())
    return (torch.cat([s for s, _, _, _ in blocks]),
            torch.cat([i[:-1] for _, i, _, _ in blocks] + [count_row]),
            Cover(torch.cat([c.need for _, _, _, c in blocks]),
                  blocks[0][3].mode))


def topk_certified_multi(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                         size=None, sub_batch: int = 1024, tile: int = 4096,
                         groups: int = 8, union_tiles: int = 32,
                         pad_r: int | None = None, row_scale=None,
                         int8_native: bool = True):
    """``topk_certified`` over M sub-batches; the certificate row sums the
    blocks' uncovered counts (-1 if any block's range flag is set). Ports
    ``pallas_topk_certified_multi``."""
    s, ids, _ = _certified(queries, corpus, k, size, sub_batch, tile, groups,
                           union_tiles, pad_r, row_scale, int8_native)
    return s, ids


def _check_flag(flag: torch.Tensor) -> None:
    if bool(flag[0] > 0):
        raise ValueError(RANGE_ERROR)


def _ann_small(queries, corpus, k, size, row_scale):
    """The exact answer where the packed scan has too few tiles, ids of
    missing rows -1 (the reference asserts there instead)."""
    s, i = exact_topk(queries, corpus, k, size, row_scale=row_scale)
    pad = k - s.shape[1]
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
        i = torch.nn.functional.pad(i, (0, pad), value=-1)
    return s, torch.where(s > NEG_INF / 2, i, -1)


def topk_ann(queries: torch.Tensor, corpus: torch.Tensor, k: int, size=None,
             tile: int = 4096, groups: int = 8, oversample: int = 32,
             row_scale=None):
    """Approximate top-k at near-scan speed: the certified path's packed
    scan and c1 rescore (its units plus +-4 column windows), no covers, no
    certificate. Ports ``pallas_topk_ann``. Returns (scores [B, k] f32,
    exact rescores, ids [B, k] int64, -1 where fewer than k rows were
    found).

    Where the scan has too few tiles (2*(N/tile) <= k, or too few
    candidates to cover k) the answer is the exact top-k instead; the
    reference raises there.
    """
    num_tiles = corpus.shape[0] // tile
    r = min(max(oversample, k + 8), 2 * num_tiles - 1)
    if 2 * num_tiles <= k or r * groups < k:
        return _ann_small(queries, corpus, k, size, row_scale)
    s, i, flag, _ = _packed_search(queries, corpus, k, size, tile, groups,
                                   32, r, row_scale, True, covers=False)
    _check_flag(flag)
    return s, i


def topk_ann_multi(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                   size=None, sub_batch: int = 1024, tile: int = 4096,
                   groups: int = 8, oversample: int = 32, row_scale=None):
    """``topk_ann`` over M sub-batches. Ports ``pallas_topk_ann_multi``."""
    mb = queries.shape[0]
    assert mb % sub_batch == 0, (mb, sub_batch)
    out = [topk_ann(queries[s0:s0 + sub_batch], corpus, k, size, tile=tile,
                    groups=groups, oversample=oversample,
                    row_scale=row_scale)
           for s0 in range(0, mb, sub_batch)]
    return (torch.cat([s for s, _ in out]), torch.cat([i for _, i in out]))


def _tau_and_last(tile_s, top_s, k, tile_k):
    """tau (the k-th merged score) [B] and each tile's last winner [B, T]."""
    return top_s[:, k - 1], tile_s[:, tile_k - 1, :].T


def topk_verified(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                  size=None, tile: int = 1024, tile_k: int = 2,
                  mem_budget: int = 1 << 26):
    """EXACT top-k from a ``tile_k`` < k per-tile pass (K6) plus a tau-bound
    rescan. Ports ``pallas_topk_verified``.

    Only tiles whose ``tile_k``-th winner beats tau (the k-th merged score)
    can hide a top-k row, and there are at most R = (k-1) // tile_k of them
    per query: their rows are gathered and rescored exactly, in query
    chunks of at most ``mem_budget`` gathered bytes.
    """
    n, d = corpus.shape
    b = queries.shape[0]
    tile_k = min(tile_k, k)
    r = (k - 1) // tile_k
    if r == 0:                        # tile_k >= k is already exact
        return tiled_topk(queries, corpus, k, size, tile=tile, tile_k=tile_k)
    assert (n // tile) * tile_k >= k, (n // tile, tile_k, k)
    tile_s, tile_i = tile_topk(queries, corpus, size, tile, tile_k)
    top_s, top_i = _merge_tile_winners(tile_s, tile_i, k)
    size_ = n if size is None else size
    tau, s_last = _tau_and_last(tile_s, top_s, k, tile_k)
    sus_val = torch.where(s_last > tau[:, None], s_last, float("-inf"))
    sus_sval, sus_t = _topk(sus_val, r)                          # [B, r]
    sus_ok = sus_sval > NEG_INF / 2
    r = sus_t.shape[1]
    qc = max(1, min(b, mem_budget // max(r * tile * d
                                         * corpus.element_size(), 1)))
    cols = torch.arange(tile, device=corpus.device)
    out_s, out_i = [], []
    for q0 in range(0, b, qc):
        q1 = min(b, q0 + qc)
        rows = (sus_t[q0:q1, :, None] * tile + cols).reshape(q1 - q0, -1)
        sc = _exact_rowwise_scores(queries[q0:q1], corpus[rows],
                                   corpus.dtype)
        valid = sus_ok[q0:q1].repeat_interleave(tile, dim=1) & (rows < size_)
        dup = (rows[:, :, None] == top_i[q0:q1, None, :]).any(-1)
        sc = torch.where(valid & ~dup, sc, NEG_INF)
        s, i = _topk_rows(torch.cat([top_s[q0:q1], sc], dim=1),
                          torch.cat([top_i[q0:q1], rows], dim=1), k)
        out_s.append(s)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def topk_verified_batch(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                        size=None, tile: int = 1024, tile_k: int = 2,
                        union_tiles: int = 32):
    """Exact top-k with a batch-union rescan: the ``tile_k`` pass (K6),
    then the ``union_tiles`` hottest suspicious tiles across the batch read
    once and rescored against every query. Ports
    ``pallas_topk_verified_batch``. Returns (scores [B, k] f32,
    ids [B+1, k] int64) with ids[B, 0] the count of (query, tile) suspicions
    the union did not cover: 0 means exact."""
    n, d = corpus.shape
    b = queries.shape[0]
    dev = corpus.device
    tile_k = min(tile_k, k)
    num_tiles = n // tile
    u = min(union_tiles, num_tiles)
    assert num_tiles * tile_k >= k, (num_tiles, tile_k, k)
    tile_s, tile_i = tile_topk(queries, corpus, size, tile, tile_k)
    top_s, top_i = _merge_tile_winners(tile_s, tile_i, k)
    size_ = n if size is None else size
    tau, s_last = _tau_and_last(tile_s, top_s, k, tile_k)
    sus = s_last > tau[:, None]                                   # [B, T]
    priority = torch.where(sus, s_last - tau[:, None],
                           float("-inf")).amax(dim=0)             # [T]
    sel_pri, sel_tiles = _topk(priority, u)
    sel_valid = sel_pri > float("-inf")
    selected = torch.zeros(num_tiles, dtype=torch.bool, device=dev)
    selected[sel_tiles] = sel_valid
    uncovered = (sus & ~selected[None, :]).sum()

    # One read of the union's tiles, rescored against every query, the
    # columns in row order so that ties go to the lower row.
    order = torch.argsort(sel_tiles)
    tiles_ord, valid_ord = sel_tiles[order], sel_valid[order]
    rows = (tiles_ord[:, None] * tile
            + torch.arange(tile, device=dev)).reshape(-1)         # [U*tile]
    gathered = corpus.view(num_tiles, tile, d)[tiles_ord].reshape(-1, d)
    q = queries.to(corpus.dtype).float()
    sc = q @ gathered.float().T                                   # [B, U*tile]
    row_ok = valid_ord.repeat_interleave(tile) & (rows < size_)
    sc = torch.where(row_ok[None, :], sc, NEG_INF)
    r_s, r_pos = _topk(sc, k)
    r_i = rows[r_pos]

    in_sel = selected[(top_i // tile).clamp(0, num_tiles - 1)]
    m_s = torch.cat([torch.where(in_sel, NEG_INF, top_s), r_s], dim=1)
    m_i = torch.cat([top_i, r_i], dim=1)
    out_s, out_i = _topk_rows(m_s, m_i, k)
    count_row = torch.zeros((1, k), dtype=torch.long, device=dev)
    count_row[0, 0] = uncovered
    return out_s, torch.cat([out_i, count_row], dim=0)


def rescore_topk(queries: torch.Tensor, corpus: torch.Tensor,
                 cand_ids: torch.Tensor, k: int, row_scale=None):
    """Exact float32 rescoring of an oversampled candidate set [B, C];
    ``row_scale`` [N] dequantizes gathered int8 rows first."""
    cand_ids = cand_ids.long()
    safe = cand_ids.clamp_min(0)
    cand = corpus[safe]                                           # [B, C, D]
    if row_scale is not None:
        cand = cand.float() * row_scale[safe][..., None].float()
    scores = _exact_rowwise_scores(queries.float(), cand, torch.float32)
    scores = torch.where(cand_ids >= 0, scores, NEG_INF)
    return _topk_rows(scores, cand_ids, k)


def certificate_uncovered(ids) -> int:
    """Uncovered count from a [B+1, k] ids array (0 = exact). Raises
    ``ValueError`` where the scan flagged a live score outside (-2, 2)."""
    uncovered = int(ids[-1, 0])
    if uncovered < 0:
        raise ValueError(RANGE_ERROR)
    return uncovered


def repair_uncovered(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                     size, tile: int, scores: torch.Tensor,
                     ids: torch.Tensor, cover: Cover, row_scale=None):
    """The exact top-k after a nonzero certificate: (scores [B, k], ids
    [B, k], the pairs' count, whether the whole search reran).

    ``scores``, ``ids``: the certified answer (ids without the certificate
    row); ``cover``: its covers' ``Cover``. K4p takes, for every (query,
    tile) pair of ``cover.need``, the tile's exact top-k for the query; the
    answer's rows in those pairs are masked and the rest merged with the
    pairs' lists. A row never examined scores below its bound, which is at
    most tau, at most the k-th answer: the answer is exact for the
    certified path's scoring. Dense and scaled, that is ``tiled_topk``'s
    function: on the CPU its answer bit for bit; on the card the c1
    rescore's sums (cuBLAS) may differ from K6's FMA chain in the last bit,
    as for a certificate of 0. The pairs' count costs one device-to-host
    wait.

    A pair costs K4p at most one K6 block (one tile against up to
    SELECTION_QUERY_BLOCK queries), and K6 runs T x ceil(B / that) blocks,
    each a tile against as many queries; so from that many pairs on the
    whole search reruns instead: ``tiled_topk``, or for the int8-native
    scoring, which no tiled kernel scores (K7 scores the scaled one), K4p
    over every pair.
    """
    b = queries.shape[0]
    num_tiles = corpus.shape[0] // tile
    need = cover.need
    pairs = need.T.nonzero()                # (tile, query), sorted by tile
    n_pairs = pairs.shape[0]
    rerun = n_pairs >= num_tiles * -(-b // SELECTION_QUERY_BLOCK)
    if rerun and cover.mode != "native":
        s, i = tiled_topk(queries, corpus, k, size, tile=tile,
                          row_scale=row_scale)
        return s, i, n_pairs, True
    if rerun:
        need = torch.ones_like(need)
        pairs = need.T.nonzero()
    pt, pq = pairs[:, 0], pairs[:, 1]
    if cover.mode == "native":
        q8, q_scale = quantize_int8(queries)
        val, col = extract_pairs(q8, corpus, size, tile, k, pt, pq,
                                 row_scale, q_scale)
    else:
        val, col = extract_pairs(queries, corpus, size, tile, k, pt, pq,
                                 row_scale)
    dev = corpus.device
    hit = need.gather(1, (ids // tile).clamp(0, num_tiles - 1))
    cand_s = torch.cat([torch.where(hit, NEG_INF, scores).reshape(-1),
                        val.reshape(-1)])                        # [(B+P)*k]
    cand_r = torch.cat([ids.reshape(-1),
                        (pt[None, :] * tile + col.long()).reshape(-1)])
    cand_q = torch.cat([torch.arange(b, device=dev).repeat_interleave(k),
                        pq.repeat(k)])
    # Each query's candidates by score, ties to the lower row.
    order = torch.argsort(cand_r, stable=True)
    order = order[torch.sort(cand_s[order], descending=True, stable=True)[1]]
    order = order[torch.sort(cand_q[order], stable=True)[1]]
    per_q = torch.full((b,), k, device=dev).index_add_(
        0, pq, torch.full_like(pq, k))     # bincount would wait for the card
    first = torch.cumsum(per_q, 0) - per_q
    top = order[first[:, None] + torch.arange(k, device=dev)]
    return cand_s[top], cand_r[top], n_pairs, rerun


def dispatch_deferred(queries, corpus, k, size=None, *, prefer_kernel=None,
                      tile=1024, chunk=65536, approx_tile_k=None,
                      row_scale=None):
    """``dispatch_topk(..., defer_certificate=True)`` with the covers'
    state: (scores, ids, ``Cover``), the ``Cover`` None where the route has
    no certificate. A nonzero certificate is the caller's to settle with
    ``repair_uncovered`` and that ``Cover``."""
    n = corpus.shape[0]
    if prefer_kernel is None:
        prefer_kernel = corpus.is_cuda and n % tile == 0 and k <= 128
    if prefer_kernel:
        if approx_tile_k is not None:
            eff_tile_k = max(approx_tile_k, -(-k // max(n // tile, 1)))
            return (*tiled_topk(queries, corpus, k, size, tile=tile,
                                tile_k=eff_tile_k, row_scale=row_scale),
                    None)
        if n // tile >= 64 * k:
            b = queries.shape[0]
            # Batches past 1024 run in sub-batches of 1024; pad rows repeat
            # the first query: a zero row's tau is 0 and would make every
            # tile suspicious.
            pad = (-b) % 1024 if b > 1024 else 0
            q_run = (torch.cat([queries, queries[:1].expand(pad, -1)])
                     if pad else queries)
            scores, packed, cover = _certified(
                q_run, corpus, k, size, sub_batch=min(b, 1024), tile=tile,
                row_scale=row_scale)
            if pad:
                scores = scores[:b]
                packed = torch.cat([packed[:b], packed[-1:]])
                cover = Cover(cover.need[:b], cover.mode)
            return scores, packed, cover
        return (*tiled_topk(queries, corpus, k, size, tile=tile,
                            row_scale=row_scale), None)
    if n > chunk:
        return (*chunked_topk(queries, corpus, k, size, chunk=chunk,
                              row_scale=row_scale), None)
    return (*exact_topk(queries, corpus, k, size, row_scale=row_scale), None)


def dispatch_topk(queries, corpus, k, size=None, *, prefer_kernel=None,
                  tile=1024, chunk=65536, approx_tile_k=None,
                  defer_certificate=False, row_scale=None):
    """Pick the top-k implementation for the device and problem size.

    Exact at every scale. With the kernels (by default: a CUDA corpus,
    N % tile == 0 and k <= 128), corpora of at least 64*k tiles take the
    certified packed path, smaller ones the tiled kernel search; otherwise
    plain chunked or exact matmuls. Precondition of the certified path:
    normalised inputs, every score in (-2, 2).

    ``defer_certificate=True`` returns the certified path's ids with the
    certificate row still attached ([B+1, k]); the caller reruns
    ``tiled_topk`` when ``certificate_uncovered(ids)`` is nonzero (or
    repairs the uncovered pairs with ``dispatch_deferred``'s ``Cover``).
    Without deferring, a nonzero certificate is settled here by
    ``repair_uncovered``: the same answer as the rerun where the scoring is
    ``tiled_topk``'s; for the int8-native scoring the exact answer of that
    scoring, as a certificate of 0 gives (the reference reruns K7, which
    scores the scaled function).
    ``approx_tile_k`` opts into unverified approximate extraction.
    ``row_scale`` [N] goes to every route: K7 for the tiled search, the
    int8-native K3/K5b (int8 corpus) or the scaled K2/K5a (float corpus)
    for the certified one.
    """
    scores, ids, cover = dispatch_deferred(
        queries, corpus, k, size, prefer_kernel=prefer_kernel, tile=tile,
        chunk=chunk, approx_tile_k=approx_tile_k, row_scale=row_scale)
    if cover is None or defer_certificate:
        return scores, ids
    if certificate_uncovered(ids) == 0:
        return scores, ids[:-1]
    s, i, _, _ = repair_uncovered(queries, corpus, k, size, tile, scores,
                                  ids[:-1], cover, row_scale=row_scale)
    return s, i
