"""Dense top-k retrieval: exact scans, the tiled kernel search and the
certified packed search.

Held against ``optimized_rag_tpu/ops/topk.py`` (:38-135, :198-309,
:697-756, :759-989, :1214-1340). Every function returns
``(scores [B, k] f32, ids [B, k])``; the certified ones append the
certificate row to ids. Ties go to the lower index everywhere, as
``lax.top_k`` and ``jnp.argmax`` give them: ``torch.topk`` promises no tie
order, so every selection here is a stable descending sort over candidates
in row order (``_topk_rows`` puts them in row order where they come in
another). The JAX certified path and ``rescore_topk`` order exact ties by
candidate rank instead; here they take the lower row, as every other path
does.

All float32 products run in full float32 (``device.configure_numerics``
turns TF32 off): the certificate's two-step cushion (``_unpack_ub``) allows
for reduction-order drift between the scan and the covers, not for TF32.

int8 corpora (``row_scale`` [N], ops/quantize.py): the plain scans and
``rescore_topk`` dequantize; ``tiled_topk`` runs K7 (bf16 query x codes,
x row scale); ``topk_certified`` quantizes the queries and runs the
int8-native K3 scan and K5b cover, whose scores
``(float(i32) * row_scale) * q_scale`` its c1 rescore repeats bit for bit.

Not ported yet: the bf16-operand scaled certified route
(``int8_native=False``, kernels K2 and K5a), the verified and ANN variants,
and ``tile_k``-approximate extraction beyond ``dispatch_topk``'s
``approx_tile_k`` opt-in.
"""

from __future__ import annotations

import torch

from optimized_rag_tpu_torch.ops.quantize import quantize_int8
from optimized_rag_tpu_torch.ops.topk_kernels import (
    NEG_INF, extract, extract_int8, packed_extract, packed_extract_int8,
    tile_topk, tile_topk_scaled)


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
    for an int8 corpus with ``row_scale``) then a merge. Ports
    ``pallas_topk``. ``tile_k < k`` is approximate."""
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
    widened to float32 (bf16 values are exact in f32), f32 products."""
    q = queries.to(dtype).float()
    return torch.bmm(gathered.float(), q[:, :, None])[:, :, 0]


def _exact_rowwise_scores_int8(q8: torch.Tensor, gathered: torch.Tensor,
                                row_scale: torch.Tensor,
                                q_scale: torch.Tensor) -> torch.Tensor:
    """The int8-native score of per-query gathered rows [B, M, D] -> [B, M]:
    the code dot as a float32 product of the codes (exact: every partial
    sum is an integer below 2**24 for D <= 1040), then the kernels'
    multiply order, ``(raw * row_scale) * q_scale``."""
    raw = torch.bmm(gathered.float(), q8.float()[:, :, None])[:, :, 0]
    return (raw * row_scale) * q_scale[:, None]


def _unpack_lb(vals: torch.Tensor, tile: int) -> torch.Tensor:
    """Quantised lower bound of the score from a packed int32."""
    return (vals & -tile).view(torch.float32) - 2.0


def _unpack_ub(vals: torch.Tensor, tile: int) -> torch.Tensor:
    """Upper bound: one quantisation step, plus one step of cushion for
    reduction-order drift between the scan and the rescore."""
    return ((vals & -tile) + 2 * tile).view(torch.float32) - 2.0


def topk_certified(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                   size=None, tile: int = 4096, groups: int = 8,
                   union_tiles: int = 32, pad_r: int | None = None,
                   row_scale=None, int8_native: bool = True):
    """EXACT top-k by the packed scan (K1) plus three certified covers.
    Ports ``pallas_topk_certified``.

    queries [B, D] normalised (scores in (-2, 2)); corpus [N, D] with
    N % tile == 0 and 2*(N/tile) > k. Returns (scores [B, k] f32,
    ids [B+1, k] int64) with ids[B, 0] the uncovered count: 0 means exact
    for the corpus-dtype scoring; otherwise rerun with ``tiled_topk``.

    c1 rescored exactly the top-R candidates with their full strided units;
    c2 takes the exact per-tile top-k (K4) of the union of tiles whose
    second unit may beat tau; c3 checks the best excluded candidate.

    An int8 corpus with ``row_scale`` [N] runs int8-native: the queries are
    quantized on their device (ops/quantize.py), K3 scans and K5b covers,
    and every score is ``(float(i32) * row_scale) * q_scale``, so the
    certificate means exact for that scoring. ``int8_native=False`` (the
    bf16-operand scaled kernels K2 and K5a) is not ported yet.
    """
    n, d = corpus.shape
    b = queries.shape[0]
    dev = corpus.device
    small = tile // groups
    num_tiles = n // tile
    assert 2 * num_tiles > k, (num_tiles, k)
    size_ = n if size is None else size
    native = row_scale is not None
    if native:
        if corpus.dtype != torch.int8 or not int8_native:
            raise NotImplementedError(
                "the scaled certified scan (kernels K2 and K5a: bf16 "
                "operands times row_scale) is not ported yet; use an int8 "
                "corpus with int8_native=True")
        # Float32 products of the codes are exact only below 2**24.
        assert d * 127 * 127 < 1 << 24, d
        q8, q_scale = quantize_int8(queries)
        w_val = packed_extract_int8(q8, q_scale, corpus, row_scale, size,
                                    tile, groups)                # [T, 2, B]
    else:
        w_val = packed_extract(queries, corpus, size, tile, groups)

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
    flat = members.reshape(b, r_cnt * groups)
    okf = (valid_cand[:, :, None] & (members < size_)).reshape(b, -1)
    safe = flat.clamp_min(0)
    gathered = corpus[safe]                                       # [B, M, D]
    if native:
        sc = _exact_rowwise_scores_int8(q8, gathered, row_scale[safe],
                                        q_scale)
    else:
        sc = _exact_rowwise_scores(queries, gathered, corpus.dtype)
    sc = torch.where(okf, sc, NEG_INF)
    top_s, top_i = _topk_rows(sc, flat, k)
    tau = top_s[:, k - 1]

    # c3: the best excluded candidate must be provably below tau.
    c3_viol = _unpack_ub(vtop[:, r_cnt], tile) > tau

    # c2: tiles whose second unit may beat tau, covered by the exact
    # per-tile top-k of the union (K4).
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
    if native:
        uval, ucol = extract_int8(q8, q_scale, corpus, row_scale, size,
                                  tile, k, sel_tiles.to(torch.int32))
    else:
        uval, ucol = extract(queries, corpus, size, tile, k,
                             sel_tiles.to(torch.int32))           # [U, k, B]
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
    count_row = torch.zeros((1, k), dtype=torch.long, device=dev)
    count_row[0, 0] = uncovered
    return out_s, torch.cat([out_i, count_row], dim=0)


def topk_certified_multi(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                         size=None, sub_batch: int = 1024, tile: int = 4096,
                         groups: int = 8, union_tiles: int = 32,
                         pad_r: int | None = None, row_scale=None,
                         int8_native: bool = True):
    """``topk_certified`` over M sub-batches; the certificate row sums the
    blocks' uncovered counts. Ports ``pallas_topk_certified_multi``."""
    mb = queries.shape[0]
    assert mb % sub_batch == 0, (mb, sub_batch)
    scores, ids, uncovered = [], [], 0
    for s0 in range(0, mb, sub_batch):
        s, i = topk_certified(queries[s0:s0 + sub_batch], corpus, k, size,
                              tile=tile, groups=groups,
                              union_tiles=union_tiles, pad_r=pad_r,
                              row_scale=row_scale, int8_native=int8_native)
        scores.append(s)
        ids.append(i[:-1])
        uncovered = uncovered + i[-1, 0]
    count_row = torch.zeros((1, k), dtype=torch.long, device=corpus.device)
    count_row[0, 0] = uncovered
    return torch.cat(scores), torch.cat(ids + [count_row])


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
    """Uncovered count from a [B+1, k] ids array (0 = exact)."""
    return int(ids[-1, 0])


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
    ``tiled_topk`` when ``certificate_uncovered(ids)`` is nonzero.
    ``approx_tile_k`` opts into unverified approximate extraction.
    ``row_scale`` [N] (int8 corpus) goes to every route: K7 for the tiled
    search, the int8-native K3/K5b for the certified one.
    """
    n = corpus.shape[0]
    if prefer_kernel is None:
        prefer_kernel = corpus.is_cuda and n % tile == 0 and k <= 128
    if prefer_kernel:
        if approx_tile_k is not None:
            eff_tile_k = max(approx_tile_k, -(-k // max(n // tile, 1)))
            return tiled_topk(queries, corpus, k, size, tile=tile,
                              tile_k=eff_tile_k, row_scale=row_scale)
        if n // tile >= 64 * k:
            b = queries.shape[0]
            if b > 1024:
                # Pad rows repeat the first query: a zero row's tau is 0 and
                # would make every tile suspicious.
                pad = (-b) % 1024
                q_run = (torch.cat([queries, queries[:1].expand(pad, -1)])
                         if pad else queries)
                scores, packed = topk_certified_multi(
                    q_run, corpus, k, size, sub_batch=1024, tile=tile,
                    row_scale=row_scale)
                if pad:
                    scores = scores[:b]
                    packed = torch.cat([packed[:b], packed[-1:]])
            else:
                scores, packed = topk_certified(queries, corpus, k, size,
                                                tile=tile,
                                                row_scale=row_scale)
            if defer_certificate:
                return scores, packed
            if certificate_uncovered(packed) == 0:
                return scores, packed[:-1]
            return tiled_topk(queries, corpus, k, size, tile=tile,
                              row_scale=row_scale)
        return tiled_topk(queries, corpus, k, size, tile=tile,
                          row_scale=row_scale)
    if n > chunk:
        return chunked_topk(queries, corpus, k, size, chunk=chunk,
                            row_scale=row_scale)
    return exact_topk(queries, corpus, k, size, row_scale=row_scale)
