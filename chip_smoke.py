#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: the /search serving path,
the retrieval half of a chat turn, and the reference benchmark's retrieval
path.

    python3 chip_smoke.py            # from any directory; needs one CUDA card

Phases, each printing one JSON line with its seconds:

1. ``device``  the card, and its name and power limit from nvidia-smi;
2. ``build``   nvcc builds the top-k kernels (optimized_rag_tpu_torch/csrc)
               into build/torch_kernels/ and ctypes loads them;
3. ``kernels`` each kernel against its plain PyTorch twin, N=262,144, D=384,
               B in {1, 64, 1024} at tile 1024 and B=1024 at tile 4096,
               with times: K1 packed scan, K4 union extraction and K6 tile
               top-k over f32 and bf16 rows (K1's words held by value and
               by the row their column bits name), F (the scan floor) over
               bf16 rows, then K3, K5b (bit for bit), K7, K2 (held as K1)
               and K5a (as K4) over int8 rows; then the tensor-core scan's
               raw sums on adversarial operands within the rounding bound
               of csrc/scan_mma.cuh (D=128 and 384, full and split): K1's
               main loop over bf16 rows and K2's over int8 codes (raw,
               and scaled at mixed row scales);
4. ``slice_f32``  the pretrained BiEncoder embeds the qa_docs chunks into a
               DenseIndex filled to 4,194,304 rows (6.4 GB f32) with clustered
               synthetic rows and contiguous near-duplicate runs; a
               QueryServer answers 256 queries from 8 client threads in
               bursts, then 256 in closed loop; every answer must have the
               chunked exact f32 oracle's ids; a 131,072-row index routes to
               K6 alone; 64 queries go one at a time through the certified
               search, and each answer its certificate passes is held against
               the oracle; a forced fallback reruns K6;
5. ``slice_bf16`` the same rows in bf16 storage through DenseIndex.search,
               held against the plain bf16-scan, top-40, f32-rescore
               pipeline, and its certified answers one query at a time;
6. ``slice_int8`` int8 storage: 16,777,216 rows (6.44 GB of codes, 4x the
               f32 slice's rows in the same bytes) filled by the same
               generator, quantize_int8 on the card held bit for bit against
               the CPU over every row and query; the same two QueryServer
               loads, a direct search of 64 queries and a 131,072-row index
               (K7 alone); every answer held against the oracle of the route
               its batch took (certified: exact int8-native scores; fallback
               or direct: K7's scoring, differences allowed only at a
               near-tied cc-th candidate, counted); 64 queries alone through
               the certified int8 search; recall@10 against the f32 oracle of
               the unquantized rows printed, not gated;
7. ``slice_hybrid`` the retrieval half of a chat turn: 262,144 chunks (the
               qa_docs chunks and seeded 40-word filler chunks of their own
               words, created over the last 365 days) embedded by the
               pretrained BiEncoder on the card in batches of 128 into a
               float32 DenseIndex (tile 1024) and added to a LexicalIndex
               (the agent's defaults); 64 queries one at a time through
               HybridRetriever's one-call route (the encoder forward inside
               encode_and_retrieve) and two-call route (dual_topk, then
               fuse_candidates), dense_only at k=2 (certified: K1 -> K4)
               and k=10 (K6), the separate-dispatch route after 16 deletes
               (K6 at k = 66), and FusedRerankEval with the pretrained
               cross-encoder (checkpoints/pretrained/crossencoder.params.npz)
               in modes ce and emb beside the modular SelectiveReranker;
               every answer held against a float64 numpy oracle (ids equal
               unless the oracle shows a near-tie of 1e-5, fused scores
               within 1e-5), the two hybrid routes against each other, the
               MMR selection, relevance and pairwise cosine against a numpy
               oracle, fused against modular, the card's cross-encoder
               logits against the port's CPU run; per-route host ms, per-stage
               CUDA-event ms, ingest and lexical build seconds;
8. ``bench_shape`` the reference benchmark's retrieval path at its full
               shape (bench.py:180-265, :540-575): 10,485,760 x 128 bf16
               rows (clustered, 300 near-duplicate runs), tile 4096, k=10,
               unit-normal queries in batches of 1024 and 512; the
               certified search (b1024, b512, two sub-batches of 512), ANN
               at oversample 32 (held against the same pipeline with the
               scan's twin; recall printed), the verified searches (tile
               1024 and the tile-4096 batch union), the same rows as int8
               codes on the int8-native (union 64, pad_r 26) and scaled
               (K2 -> K5a) routes, and F; every certified or verified answer
               equals its route's oracle, a nonzero certificate's rerun
               too, and its rerun is timed in the route's record; qps and
               ms per route and batch. Every kernel call the
               routes make is recorded, and one call of each distinct
               shape is held against its twin and timed there.

Launch counts are set to 0 just before each path and read just after it.
Then the card's nvidia-smi line; one JSON line with an entry for each
kernel at each shape a user path gives it (the served slices' paths:
QueryServer rounds, DenseIndex.search and the small indexes; each shape of
bench_shape's routes; and each shape of slice_hybrid's dense routes), its
numbers measured at that shape and its
``launches`` counted on those paths alone (``launches_by_path`` gives each
path), its ``bound_share`` (bound_ms / ms) and its ``library_factor``
(ms / library_ms); and last the ``{"ok": true, ...}`` line. Any failure
raises: the traceback is printed and the exit code is not 0. A watchdog
interrupts the script after DEADLINE_S seconds.
"""

from __future__ import annotations

import _thread
import contextlib
import glob
import json
import os
import random
import re
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEADLINE_S = 560
SEED = 1234
DIM, TILE, GROUPS = 384, 1024, 8
N_BIG = 4_194_304                 # rows of the served index (6.4 GB in f32)
N_SMALL = 131_072                 # below 64*k tiles: routes straight to K6
N_KERNEL = 262_144                # rows of the kernels phase
CAPACITY_BLOCK = 65_536           # DenseIndex growth block, as the agent's
K = 10                            # what clients ask for
K_SERVED = 1 << (K - 1).bit_length()  # QueryServer's power-of-two bucket
CC_SERVED = 4 * K_SERVED          # int8 candidates: a 4x oversample
N_INT8 = 16_777_216               # rows of the int8 index (6.44 GB of codes)
N_QUERIES, N_CLIENTS = 256, 8
# The reference benchmark's retrieval shape (bench.py:180-183): 10,485,760
# x 128 bf16 rows, tile 4096, k 10, batches of 1024 and 512.
N_BENCH, DIM_BENCH, BENCH_TILE = 10_485_760, 128, 4096
B_HEAD, B_CMP = 1024, 512
MAX_DEVICE_BYTES = 30e9
TIE_TOL = 1e-5                    # f32 scores: ~1e-7 summation-order drift
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 on the CUDA
# cores, bf16 on the tensor cores,
# int8 on the tensor cores.
PEAK_BW, PEAK_F32, PEAK_BF16, PEAK_INT8 = 3.35e12, 67e12, 989e12, 1979e12
_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def start_watchdog() -> None:
    """Interrupt the main thread at the deadline; if it is stuck in native
    code, end the process 30 s later."""
    def fire():
        print(f"chip_smoke: deadline of {DEADLINE_S} s passed", file=sys.stderr,
              flush=True)
        _thread.interrupt_main()
        time.sleep(30)
        os._exit(1)
    timer = threading.Timer(DEADLINE_S, fire)
    timer.daemon = True
    timer.start()


def median_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)).clamp_min(
        1e-12)


# ------------------------------------------------------------------ data

def clustered_rows(n, gen, centers):
    """benchmarks/common.py:40-76 in torch: cluster centre * 2 + noise."""
    dev = centers.device
    assign = torch.randint(0, centers.shape[0], (n,), generator=gen,
                           device=dev)
    return unit(centers[assign] + torch.randn(n, centers.shape[1],
                                              generator=gen, device=dev))


def near_duplicates(base, n, gen):
    """``n`` rows at cosine ~0.98 to ``base``: base + 0.2 * unit noise."""
    noise = unit(torch.randn(n, base.shape[0], generator=gen,
                             device=base.device))
    return unit(base[None, :] + 0.2 * noise)


def plan_runs(rng: random.Random, n_rows, first_row, n_runs):
    """Non-overlapping run slots [start, start+len), 32-row aligned so no
    run straddles a tile; lengths 8..32."""
    slots = rng.sample(range(-(-first_row // 32), n_rows // 32), n_runs)
    return sorted((s * 32, rng.randint(8, 32)) for s in slots)


def qa_chunks():
    out = []
    for path in sorted(glob.glob(os.path.join(
            HERE, "optimized_rag_tpu", "eval", "qa_docs", "*.md"))):
        with open(path, encoding="utf-8") as f:
            out += [p.strip() for p in f.read().split("\n\n") if p.strip()]
    if not out:
        raise FileNotFoundError("no qa_docs chunks next to chip_smoke.py")
    return out


def make_queries(chunks, rng: random.Random, exclude=frozenset()):
    """N_QUERIES distinct sentences of the chunks, about 40% lightly
    reworded, none of them in ``exclude``."""
    sents = [s.strip() for c in chunks
             for s in re.split(r"(?<=[.?!])\s+|\n+", c) if len(s.split()) > 3]
    prefixes = ["tell me about", "what does the doc say on", "explain"]
    out, seen = [], set(exclude)
    for _ in range(100 * N_QUERIES):
        if len(out) == N_QUERIES:
            return out
        s = rng.choice(sents)
        if rng.random() < 0.4:
            words = s.lower().rstrip(".?!").split()
            s = f"{rng.choice(prefixes)} {' '.join(words[1:])}"
        if s not in seen:
            seen.add(s)
            out.append(s)
    raise ValueError(f"only {len(out)} distinct queries in the qa_docs")


# ------------------------------------------------------------- checking

def running_topk(score, size, k, m, dev, chunk=262_144):
    """Exact top-k of ``score(lo, hi)`` -> [M, hi-lo] over rows [0, size),
    chunk by chunk, ties to the lower row: [M, k] scores, ids."""
    best_s = torch.full((m, k), float("-inf"), device=dev)
    best_i = torch.full((m, k), -1, dtype=torch.long, device=dev)
    for lo in range(0, size, chunk):
        hi = min(size, lo + chunk)
        cand_s = torch.cat([best_s, score(lo, hi)], dim=1)
        cand_i = torch.cat([best_i, torch.arange(lo, hi, device=dev)
                            .expand(m, -1)], dim=1)
        best_s, pos = torch.sort(cand_s, dim=1, descending=True, stable=True)
        best_s, pos = best_s[:, :k], pos[:, :k]
        best_i = torch.gather(cand_i, 1, pos)
    return best_s, best_i


def oracle_topk(q, corpus, size, k, scan_dtype=torch.float32,
                chunk=262_144):
    """Chunked exact top-k, ties to the lower row: [B, k] scores, ids."""
    qs = q.to(scan_dtype).float()
    return running_topk(lambda lo, hi: qs @ corpus[lo:hi].float().T, size,
                        k, q.shape[0], q.device, chunk)


def int8_oracle(qn, c8, cs, size, k):
    """Top-k of an int8 corpus under both of the int8 search's scorings,
    ties to the lower row, for queries ``qn`` [M, D] normalised as the
    index normalised them. "certified": the int8-native score, a float32
    product of the codes (exact below 2**24), * cs, * qs; "k7": the
    fallback's, bf16(q) x codes, an f32 sum, * cs."""
    from optimized_rag_tpu_torch.ops.quantize import quantize_int8
    q8, qs = quantize_int8(qn)
    q8f, qb = q8.float(), qn.to(torch.bfloat16).float()
    m, dev = qn.shape[0], qn.device
    return {
        "certified": running_topk(
            lambda lo, hi: ((q8f @ c8[lo:hi].float().T) * cs[lo:hi])
            * qs[:, None], size, k, m, dev),
        "k7": running_topk(
            lambda lo, hi: (qb @ c8[lo:hi].float().T) * cs[lo:hi],
            size, k, m, dev)}


def rescore_oracle(qn, c8, cs, cand, kk):
    """Float32 rescore of dequantized candidate rows in rescore_topk's
    arithmetic (a batched matmul), top-kk, ties to the lower row."""
    cand = cand.sort(dim=1).values
    rows = c8[cand].float() * cs[cand][..., None]
    s = torch.bmm(rows, qn[:, :, None])[:, :, 0]
    s, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return s[:, :kk], torch.gather(cand, 1, pos[:, :kk])


def hold_route(what, route, ids, vals, oracle, qn, c8, cs, cc, kk):
    """Answers [B, >=k] of one int8 search against the oracle of the route
    it took. Certified: every id equal to the pipeline of exact int8-native
    scores, top-cc, f32 rescore, top-kk. Fallback or direct (K7): the same
    pipeline with K7's scoring; an answer may differ only where the
    oracle's cc-th and (cc+1)-th candidates score within TIE_TOL (K7 sums
    in another order). Returns the count of such boundary differences."""
    o_s, o_i = oracle["certified" if route == "certified" else "k7"]
    want_s, want_i = rescore_oracle(qn, c8, cs, o_i[:, :cc], kk)
    k = ids.shape[1]
    differ = (ids.long() != want_i[:, :k]).any(dim=1)
    edge = (o_s[:, cc - 1] - o_s[:, cc]).abs() <= TIE_TOL
    if route == "certified":
        check_answers(what, ids, vals, want_i[:, :k], want_s[:, :k])
        return 0
    bad = differ & ~edge
    if bool(bad.any()):
        j = int(bad.nonzero()[0, 0])
        check_answers(f"{what} (row {j}, {route})", ids[j:j + 1],
                      vals[j:j + 1], want_i[j:j + 1, :k],
                      want_s[j:j + 1, :k])
    same = ~differ
    if bool(same.any()):
        check_answers(f"{what} ({route})", ids[same], vals[same],
                      want_i[same, :k], want_s[same, :k])
    return int(differ.sum())


def check_selection(what, q, corpus, ids, vals, ids_ref, vals_ref,
                    tol=TIE_TOL, row_scale=None, rows_dtype=None):
    """A kernel's selections [S, k, B] (query b on the last axis) agree with
    its twin's.

    Scores must match within ``tol``. Ids must match, except where two rows
    score within the drift of two f32 summation orders (a near-tie): there
    the returned row must really score its value (rows rounded to
    ``rows_dtype``, then ``* row_scale``, for the scaled kernels). Returns
    (worst score error, count of near-tie swaps)."""
    err = float((vals - vals_ref).abs().max())
    if err > tol:
        raise AssertionError(f"{what}: scores differ by {err:.3g} > {tol}")
    mism = ids != ids_ref
    swaps = int(mism.sum())
    if swaps:
        qi = torch.arange(q.shape[0], device=q.device).expand_as(ids)
        sel = ids[mism].long()
        rows = corpus[sel] if rows_dtype is None else corpus[sel].to(
            rows_dtype)
        true = (rows.float() * q[qi[mism]]).sum(-1)
        if row_scale is not None:
            true = true * row_scale[sel]
        bad = float((true - vals[mism]).abs().max())
        if bad > tol:
            raise AssertionError(f"{what}: {swaps} ids differ and a returned "
                                 f"row scores {bad:.3g} off its value")
    # Live rows are distinct (padding rows all score -1e30 and may repeat).
    live = torch.where(vals > -1e29, ids.long(), -1 - torch.arange(
        ids.numel(), device=ids.device).view_as(ids))
    srt = live.sort(dim=1).values
    if not bool((srt[:, 1:] != srt[:, :-1]).all()):
        raise AssertionError(f"{what}: a row is selected twice")
    return err, swaps


def check_answers(what, ids, vals, ids_ref, vals_ref, tol=TIE_TOL):
    """Answers [B, k] against the oracle's: every id equal, scores within
    ``tol``. Returns the worst score error."""
    differ = ids.long() != ids_ref.long()
    if bool(differ.any()):
        where = differ.nonzero().tolist()
        rows = [(b, j, int(ids[b, j]), float(vals[b, j]), int(ids_ref[b, j]),
                 float(vals_ref[b, j])) for b, j in where[:8]]
        same_sets = all(set(ids[b].tolist()) == set(ids_ref[b].tolist())
                        for b in {b for b, _ in where})
        raise AssertionError(
            f"{what}: {len(where)} ids differ from the oracle's (same id "
            f"sets: {same_sets}); (query, rank, id, score, oracle id, oracle "
            f"score): {rows}")
    err = float((vals - vals_ref).abs().max())
    if err > tol:
        raise AssertionError(f"{what}: scores differ by {err:.3g} > {tol}")
    return err


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BW, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -------------------------------------------------------- kernel holding

LIB_ELEMS = 1 << 30               # largest [B, rows] yardstick score block


def kernel_kind(name):
    """"int8" (int8-native: K3, K5b), "scaled" (K2, K5a, K7) or "dense"."""
    return ("int8" if name.endswith("_int8")
            else "scaled" if name.endswith("_scaled") else "dense")


def call_operands(name, args):
    """A wrapper call's arguments, as ops/topk.py passes them, split into
    (queries or query codes, corpus, row scales, size, tile, m, tiles,
    arguments without the range flag); m is groups, rounds or tile_k."""
    kind = kernel_kind(name)
    if name == "scan_floor":
        q, corpus, tile = args
        return q, corpus, None, None, tile, 1, None, args
    core = args
    if name.startswith("packed"):         # drop the range flag, if passed
        core = args[:{"dense": 5, "scaled": 6, "int8": 7}[kind]]
    if kind == "int8":
        q, _, corpus, cs, size, tile, m, *rest = core
    elif kind == "scaled":
        q, corpus, cs, size, tile, m, *rest = core
    else:
        (q, corpus, size, tile, m, *rest), cs = core, None
    tiles = rest[0] if name.startswith("extract") else None
    return q, corpus, cs, size, tile, m, tiles, core


def lib_scores(qs, rows):
    """The library yardstick's matmul: f32 GEMM for an f32 corpus, bf16
    GEMM (tensor cores, bf16 output) for a bf16 one."""
    if rows.dtype == torch.bfloat16:
        return torch.matmul(qs.to(torch.bfloat16), rows.transpose(-1, -2))
    return torch.matmul(qs, rows.transpose(-1, -2))


def int8_scores_lib(q8, rows8):
    """The int8 yardstick's matmul: ``torch._int_mm`` (cuBLASLt s8 x s8 ->
    s32) where its shape rules allow (more than 16 queries, widths a
    multiple of 8), else a float32 matmul of the codes."""
    try:
        return torch._int_mm(q8, rows8.T), "torch._int_mm"
    except RuntimeError:
        return q8.float() @ rows8.float().T, "float32 matmul of the codes"


def library_call(K_, name, q, corpus, cs, tile, m, tiles):
    """One PyTorch computation of the kernel's function on the same inputs,
    never called by the port: a GEMM (bf16 of bf16(q) and the rows as bf16,
    x scales, for the scaled kernels; ``torch._int_mm`` for the int8-native
    ones), then ``torch.topk`` (``amax`` for F) per tile. Over the whole
    corpus it runs in row blocks where one [B, N] score matrix would exceed
    LIB_ELEMS. Returns (callable, label)."""
    kind = kernel_kind(name)
    b, (n, d) = q.shape[0], corpus.shape
    if kind == "int8":
        score = lambda rows, rs: int8_scores_lib(q, rows.reshape(-1, d))[0]
        label = int8_scores_lib(q, corpus[:tile])[1]
        src = corpus
    elif kind == "scaled":
        q16 = q.to(torch.bfloat16)
        score = lambda rows, rs: torch.matmul(q16, rows.transpose(-1, -2)) \
            .mul_(rs)
        label = "bf16 torch.matmul, * scale"
        src = corpus.to(torch.bfloat16)   # made once, outside the timing
    else:
        qs = K_._scan_queries(q, corpus)
        score = lambda rows, rs: lib_scores(qs, rows)
        label = f"{'bf16' if corpus.dtype == torch.bfloat16 else 'f32'} " \
                "torch.matmul"
        src = corpus
    if tiles is not None:                 # the listed tiles: one call
        t_ids = tiles.long()
        sel = src.view(n // tile, tile, d)[t_ids]
        rs = None if cs is None else cs.view(n // tile, tile)[t_ids][:, None]
        if kind == "int8":
            return (lambda: torch.topk(score(sel, rs).view(b, -1, tile), m),
                    f"{label}, torch.topk")
        return lambda: torch.topk(score(sel, rs), m), f"{label}, torch.topk"
    reduce = ((lambda s: s.amax(dim=-1)) if name == "scan_floor"
              else (lambda s: torch.topk(s, m if name.startswith("tile")
                                         else 2)))
    step = n if b * n <= LIB_ELEMS else max(tile, LIB_ELEMS // b // tile
                                            * tile)

    def lib():
        for lo in range(0, n, step):
            hi = min(n, lo + step)
            reduce(score(src[lo:hi], None if cs is None else cs[lo:hi])
                   .view(b, (hi - lo) // tile, tile))
    red = "amax per tile" if name == "scan_floor" else "torch.topk"
    blocks = "" if step == n else f", in blocks of {step} rows"
    return lib, f"{label}, {red}{blocks}"


def hold_call(K_, T_, name, args, reps, where, plain_reps=None):
    """Kernel ``name`` on ``args`` (a wrapper call as ops/topk.py makes it)
    against its plain twin on the same inputs, then timed beside the twin
    and the library yardstick. int8-native kernels bit for bit; packed
    words by value (one quantisation step) and by the row their column
    bits name; selections within TIE_TOL, near-tie swaps only; F within
    TIE_TOL. Returns the record: errors, ms, plain_ms, library_ms, bytes,
    flops, bound_ms, bound_by and the call's shape."""
    kind = kernel_kind(name)
    q, corpus, cs, size, tile, m, tiles, core = call_operands(name, args)
    b, (n, d) = q.shape[0], corpus.shape
    kernel = lambda: getattr(K_, name)(*core)
    if kind == "int8":
        qt, plain_args = None, core
    else:
        qt = (K_._bf16_queries(q) if kind == "scaled"
              else K_._scan_queries(q, corpus))
        plain_args = (qt,) + tuple(core[1:])
    plain = lambda: getattr(K_, name + "_plain")(*plain_args)
    rows_dtype = (K_.scaled_rows_dtype(corpus) if kind == "scaled"
                  else None)
    out, ref = kernel(), plain()
    rec = {}
    if kind == "int8":
        differ = sum(int((a != r).sum()) for a, r in zip(
            out if isinstance(out, tuple) else (out,),
            ref if isinstance(ref, tuple) else (ref,)))
        if differ:
            raise AssertionError(f"{where} {name}: {differ} values differ "
                                 "from the twin's")
        rec.update(max_abs_err=0.0, tolerance=0.0)
        if name.startswith("packed"):     # K3: the sums are exact
            rec["score_diff"] = 0.0
    elif name.startswith("packed"):
        step = tile * 2.0 ** -22          # quantisation step on (2, 4)
        lb_err = float((T_._unpack_lb(out, tile) - T_._unpack_lb(ref, tile))
                       .abs().max())
        faults, boundary = K_.packed_word_faults(
            qt, corpus, size, tile, out, ref, drift=TIE_TOL, row_scale=cs,
            rows_dtype=rows_dtype, groups=m)
        if lb_err > step or faults:
            raise AssertionError(f"{where} {name}: lower bounds differ by "
                                 f"{lb_err:.3g} (step {step:.3g}), {faults} "
                                 "words name a wrong row or value")
        # The measured counterpart of the scan's accumulation bound: the
        # largest difference of the words' values where both name a row.
        same = (out & (tile - 1)) == (ref & (tile - 1))
        score_diff = float(torch.where(
            same, (T_._unpack_lb(out, tile) - T_._unpack_lb(ref, tile))
            .abs(), 0.0).max())
        rec.update(max_abs_err=lb_err, tolerance=step,
                   boundary_words=boundary, score_diff=score_diff)
    elif name == "scan_floor":
        err = float((out - ref).abs().max())
        if not err <= TIE_TOL:
            raise AssertionError(f"{where} scan_floor: {err:.3g} > {TIE_TOL}")
        rec.update(max_abs_err=err, tolerance=TIE_TOL, score_diff=err)
    else:
        (v, i), (v_p, i_p) = out, ref
        i, i_p = i.long(), i_p.long()
        if tiles is not None:             # tile-local columns
            base = (tiles.long() * tile)[:, None, None]
            i, i_p = i + base, i_p + base
        err, swaps = check_selection(f"{where} {name}", qt, corpus, i, v, i_p,
                                     v_p, row_scale=cs, rows_dtype=rows_dtype)
        rec.update(max_abs_err=err, tolerance=TIE_TOL, near_tie_swaps=swaps)
        del v, i, v_p, i_p
    del out, ref
    lib, label = library_call(K_, name, q, corpus, cs, tile, m, tiles)
    rec.update(ms=median_ms(kernel, reps),
               plain_ms=median_ms(plain, plain_reps or reps),
               library_ms=median_ms(lib, plain_reps or reps), library=label)
    del lib
    # Bytes: inputs read once, outputs written once; operations: 2*B*rows*D.
    t = n // tile
    row_bytes = d * corpus.element_size() + (0 if cs is None else 4)
    q_bytes = b * (d + 4) if kind == "int8" else b * d * 4
    if tiles is not None:
        u = tiles.shape[0]
        rows, out_bytes = u * tile, u * 4 + 2 * u * m * b * 4
    else:
        rows = n
        out_bytes = t * b * 4 * (1 if name == "scan_floor"
                                 else 2 * m if name.startswith("tile")
                                 else 2)
    peak = (PEAK_INT8 if kind == "int8" else PEAK_F32
            if kind == "dense" and corpus.dtype == torch.float32
            else PEAK_BF16)
    rec.update(bytes=rows * row_bytes + q_bytes + out_bytes,
               flops=2 * b * rows * d, B=b, N=n, D=d, tile=tile,
               m=m, U=None if tiles is None else tiles.shape[0])
    rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], rec["flops"],
                                                peak)
    return rec


def dense_calls(q, corpus, size, tile, tiles, rounds, floor=False):
    """K1, K4 and K6 (and F) calls on a float corpus, as the search makes
    them."""
    calls = [("packed_extract", (q, corpus, size, tile, GROUPS)),
             ("extract", (q, corpus, size, tile, rounds, tiles)),
             ("tile_topk", (q, corpus, size, tile, rounds))]
    if floor:
        calls.append(("scan_floor", (q, corpus, tile)))
    return calls


def int8_calls(q, c8, cs, size, tile, tiles, rounds, scaled=False):
    """K3, K5b and K7 (and the scaled route's K2 and K5a) calls on an int8
    corpus."""
    from optimized_rag_tpu_torch.ops.quantize import quantize_int8
    q8, qs = quantize_int8(q)
    calls = [("packed_extract_int8", (q8, qs, c8, cs, size, tile, GROUPS)),
             ("extract_int8", (q8, qs, c8, cs, size, tile, rounds, tiles)),
             ("tile_topk_scaled", (q, c8, cs, size, tile, rounds))]
    if scaled:
        calls += [("packed_extract_scaled", (q, c8, cs, size, tile, GROUPS)),
                  ("extract_scaled", (q, c8, cs, size, tile, rounds, tiles))]
    return calls


def hold_calls(K_, T_, calls, reps, where):
    """``hold_call`` of each (name, args); one record per kernel name."""
    return {name: hold_call(K_, T_, name, args, reps, where)
            for name, args in calls}


# ----------------------------------------------------------------- phases

def phase_device():
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})
    return name, smi


def phase_build():
    from optimized_rag_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    usage = [ln.strip() for ln in _build.build_info["ptxas"].splitlines()
             if "Used" in ln or "Compiling entry" in ln or "spill" in ln]
    emit({"phase": "build", "nvcc": _build.build_info["nvcc"],
          "library": os.path.relpath(_build.build_info["library"], HERE),
          "ptxas": usage, "seconds": time.perf_counter() - t0})


def phase_kernels(K_, T_, dev):
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    centers = torch.randn(4096, DIM, generator=gen, device=dev) * 2.0
    corpus32 = clustered_rows(N_KERNEL, gen, centers)
    runs = plan_runs(random.Random(SEED), N_KERNEL, 0, 24)
    for start, length in runs:
        corpus32[start:start + length] = near_duplicates(corpus32[start],
                                                         length, gen)
    size = N_KERNEL - 300                     # a partial last tile
    b_max = 1024
    src = torch.tensor([s for s, _ in runs], device=dev)
    pick = torch.cat([src, torch.randint(0, size, (b_max,), generator=gen,
                                         device=dev)])[:b_max]
    q_all = unit(corpus32[pick] + 0.5 * unit(torch.randn(
        b_max, DIM, generator=gen, device=dev)))

    def union(tile):
        """32 tile ids, the tiles holding runs first."""
        hot = sorted({s // tile for s, _ in runs})
        return torch.tensor((hot + [t for t in range(N_KERNEL // tile)
                                    if t not in hot])[:32],
                            dtype=torch.int32, device=dev)

    # (tile, batches): the search path's tile at every batch, and the
    # reference benchmark's tile 4096 at its batch of 1024.
    shapes = ((TILE, (1, 64, 1024)), (BENCH_TILE, (1024,)))
    for dtype in (torch.float32, torch.bfloat16):
        corpus = corpus32.to(dtype)
        for tile, batches in shapes:
            for b in batches:
                K_.reset_launch_counts()
                recs = hold_calls(K_, T_, dense_calls(
                    q_all[:b], corpus, size, tile, union(tile), 16,
                    floor=dtype == torch.bfloat16), reps=5,
                    where=f"kernels {dtype} B={b} tile={tile}")
                launches = K_.launch_counts()
                for name, rec in recs.items():
                    emit({"phase": "kernels", "kernel": name,
                          "dtype": str(dtype).removeprefix("torch."),
                          "launches": launches[name], **rec})
        del corpus
    from optimized_rag_tpu_torch.ops.quantize import quantize_int8
    c8, cs = quantize_int8(corpus32)
    for tile, batches in shapes:
        for b in batches:
            K_.reset_launch_counts()
            recs = hold_calls(K_, T_, int8_calls(
                q_all[:b], c8, cs, size, tile, union(tile), CC_SERVED,
                scaled=True), reps=5, where=f"kernels int8 B={b} tile={tile}")
            launches = K_.launch_counts()
            for name, rec in recs.items():
                emit({"phase": "kernels", "kernel": name, "dtype": "int8",
                      "launches": launches[name], **rec})
    del corpus32, centers, q_all, c8, cs
    # The scan's tensor-core sums against the bound its certificate rests
    # on (csrc/scan_mma.cuh), on operands that press on it: K1's main loop
    # over bf16 rows, and K2's over int8 codes (the raw sums, and the
    # scaled scores at mixed row scales).
    from optimized_rag_tpu_torch.ops import scan_rounding as R
    for rows in ("bf16", "int8"):
        for d, mode in ((128, "full"), (DIM, "full"), (DIM, "split")):
            if rows == "bf16":
                q, c = R.operands(SEED + d, 1024, 16384, d, torch.bfloat16,
                                  dev)
                scales = (None,)
            else:
                q, c, cs = R.code_operands(SEED + d, 1024, 16384, d, dev)
                scales = (None, cs)
            sums = K_.scan_sums(q, c, BENCH_TILE, split=mode == "split")
            for cs in scales:
                ratio = R.rounding_ratio(q, c, sums, mode, row_scale=cs)
                emit({"phase": "kernels", "check": "scan_rounding",
                      "rows": rows, "scaled": cs is not None, "d": d,
                      "mode": mode, "ratio_to_bound": ratio})
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"scan rounding over {rows} rows at D={d} ({mode}, "
                        f"scaled {cs is not None}): {ratio:.3g} of its "
                        "bound")
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})


def fill_index(index, svc, chunks, dev, n_rows=N_BIG, on_block=None):
    """qa_docs chunk embeddings, then clustered synthetic rows with runs of
    near-duplicates (of chunks and of synthetic rows) up to ``n_rows``
    rows, generated on the card in 2**20-row blocks; ``on_block(x, start)``
    sees each block just after it is added at row ``start``."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = random.Random(SEED)
    chunk_emb = torch.from_numpy(svc.encode(chunks)).to(dev)
    index.add(chunk_emb)
    if on_block:
        on_block(chunk_emb, 0)
    centers = torch.randn(4096, DIM, generator=gen, device=dev) * 2.0
    runs = plan_runs(rng, n_rows, len(chunks), 300)
    bases = {start: (chunk_emb[j % len(chunks)] if j < 2 * len(chunks)
                     else None)
             for j, (start, _) in enumerate(rng.sample(runs, len(runs)))}
    block = 1 << 20
    for lo in range(0, n_rows, block):
        lo_, hi = max(lo, index.size), min(n_rows, lo + block)
        x = clustered_rows(hi - lo_, gen, centers)
        for start, length in runs:
            if lo_ <= start < hi:
                base = bases[start]
                base = x[start - lo_] if base is None else base
                x[start - lo_:start - lo_ + length] = near_duplicates(
                    base, length, gen)
        index.add(x)
        if on_block:
            on_block(x, lo_)
        del x
    assert index.size == n_rows
    return runs


def drive_server(QueryServer, svc, index, queries, burst):
    """8 clients, each submitting its queries ``burst`` at a time and
    waiting on every future before the next burst (burst=1: closed loop,
    at most 8 queries in flight; burst=8: up to 64). Returns answers,
    per-request latencies (s), wall seconds and the server's stats."""
    server = QueryServer(svc.encode, index, max_batch=64, workers=2)
    answers, lat = [None] * len(queries), [0.0] * len(queries)
    errors = []

    def client(c):
        try:
            mine = list(range(c, len(queries), N_CLIENTS))
            for j in range(0, len(mine), burst):
                sent = [(i, time.perf_counter(), server.submit(queries[i], K))
                        for i in mine[j:j + burst]]
                for i, t_sub, fut in sent:
                    answers[i] = fut.result(timeout=120)
                    lat[i] = time.perf_counter() - t_sub
        except BaseException as exc:          # reported by the main thread
            errors.append(exc)

    server.start()
    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(N_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    alive = [t for t in clients + server._threads if t.is_alive()]
    if errors:
        raise errors[0]
    if alive:
        raise RuntimeError(f"{len(alive)} threads still alive after stop()")
    return answers, lat, wall, server.get_stats()


def counted(K_, paths, name, fn):
    """``fn()`` with every launch count set to 0 just before it; the counts
    read just after go into ``paths[name]``."""
    K_.reset_launch_counts()
    out = fn()
    paths[name] = K_.launch_counts()
    return out


def certified_alone(T_, q, corpus, size, k, scan_dtype):
    """Each query alone through the certified search, so its certificate is
    its own: every answer the certificate passes must equal the chunked
    exact oracle's. Returns how many queries certified."""
    o_s, o_i = oracle_topk(q, corpus, size, k, scan_dtype=scan_dtype)
    certified = 0
    for j in range(q.shape[0]):
        s, packed = T_.topk_certified(q[j:j + 1], corpus, k, size, tile=TILE)
        if T_.certificate_uncovered(packed) == 0:
            check_answers(f"certified answer {j} ({corpus.dtype})",
                          packed[:-1], s, o_i[j:j + 1], o_s[j:j + 1])
            certified += 1
    if not certified:
        raise AssertionError(f"no query certified alone ({corpus.dtype}): "
                             "no certified answer was held")
    return certified


def require_launched(paths, user_paths, names, what):
    """Every kernel of ``names`` launched at least once on the paths a user
    drives."""
    for name in names:
        if not sum(paths[p][name] for p in user_paths):
            raise AssertionError(f"{name} never launched on the {what} path")


def phase_slice_f32(K_, T_, dev, chunks, queries):
    """``queries``: two disjoint lists of N_QUERIES texts, one per round.
    Launch counts are read per path: the two served rounds, the
    131,072-row index (the user's paths), and the checks that call the
    top-k functions directly."""
    from optimized_rag_tpu_torch.index.dense import DenseIndex
    from optimized_rag_tpu_torch.models.convert import load_biencoder
    from optimized_rag_tpu_torch.serving import QueryServer
    t0 = time.perf_counter()
    svc = load_biencoder(os.path.join(HERE, "checkpoints", "pretrained"),
                         device=dev)
    cfg = svc.cfg
    index = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.float32, device=dev)
    runs = fill_index(index, svc, chunks, dev)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0

    # Warm-up: one request through the encoder and the index.
    index.search(svc.encode(["warm-up request"]), K)
    emb = index.embeddings()

    # The main path: QueryServer rounds, each counted on its own.
    paths, rounds = {}, {}
    for name, burst, texts in (("served_burst", 8, queries[0]),
                               ("served_closed_loop", 1, queries[1])):
        answers, lat, wall, stats = counted(
            K_, paths, name,
            lambda: drive_server(QueryServer, svc, index, texts, burst))
        q = unit(torch.from_numpy(svc.encode(texts)).to(dev))
        o_s, o_i = oracle_topk(q, emb, index.size, K)
        got_s = torch.tensor(np.stack([a[0] for a in answers]), device=dev)
        got_i = torch.tensor(np.stack([a[1] for a in answers]), device=dev)
        err = check_answers(f"served answers ({name})", got_i, got_s, o_i,
                            o_s)
        lat_ms = sorted(x * 1e3 for x in lat)
        rounds[name] = {
            "queries": len(texts), "clients": N_CLIENTS, "burst": burst,
            "qps": len(texts) / wall, "p50_ms": statistics.median(lat_ms),
            "p99_ms": lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))],
            "batches": stats["batches"], "avg_batch": stats["avg_batch"],
            "launches": paths[name],
            "launches_per_batch": {k: v / stats["batches"]
                                   for k, v in paths[name].items()},
            "oracle_max_err": err}

    # A 131,072-row index routes straight to the tiled kernel search.
    qb = q[:64]
    small = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.float32, device=dev)
    small.add(emb[:N_SMALL])
    res = counted(K_, paths, "small_index", lambda: small.search(qb, K))
    if paths["small_index"] != {**dict.fromkeys(K_.KERNELS, 0),
                                "tile_topk": 1}:
        raise AssertionError(f"small index did not route to K6 alone: "
                             f"{paths['small_index']}")
    os_, oi_ = oracle_topk(qb, small.embeddings(), small.size, K)
    check_answers("small index", torch.from_numpy(res.ids).to(dev),
                  torch.from_numpy(res.scores).to(dev), oi_, os_)
    require_launched(paths, USER_PATHS_F32, FLOAT_KERNELS, "f32")

    # Certified answers held one query at a time (served batches mostly
    # fall back, so few certified answers reach the oracle above).
    kk = K_SERVED
    n_cert = counted(K_, paths, "certified_alone", lambda: certified_alone(
        T_, q[:64], emb, index.size, kk, torch.float32))

    # Forced fallback: one union slot cannot cover the batch, so the
    # deferred certificate reads nonzero and DenseIndex's settle step
    # reruns the exact tiled search (K6).
    def forced():
        s_c, packed = T_.topk_certified(qb, emb, kk, index.size, tile=TILE,
                                        union_tiles=1)
        return T_.certificate_uncovered(packed), index._settle_certificate(
            qb, s_c, packed.cpu().numpy(), kk)
    uncovered, (f_s, f_i, route) = counted(K_, paths, "forced_fallback",
                                           forced)
    if uncovered == 0 or route != "fallback":
        raise AssertionError("union_tiles=1 certified every query: the "
                             "forced fallback did not trigger")
    if paths["forced_fallback"]["tile_topk"] != 1:
        raise AssertionError("the fallback did not rerun K6")
    of_s, of_i = oracle_topk(qb, emb, index.size, kk)
    check_answers("forced fallback", torch.from_numpy(f_i).to(dev),
                  torch.from_numpy(f_s).to(dev), of_i, of_s)
    d_s, d_i = counted(K_, paths, "dispatch_topk", lambda: T_.dispatch_topk(
        qb, emb, kk, index.size, tile=TILE))
    check_answers("dispatch_topk", d_i, d_s, of_i, of_s)

    # Where a served batch's time goes: each layer alone, host clock
    # around synchronised work, median of 3 (fresh texts: cache misses).
    layers = {}
    for b in (64, 8):
        for r in range(4):
            t1 = time.perf_counter()
            qv = svc.encode([f"{t} ({b}/{r})" for t in queries[0][:b]])
            t2 = time.perf_counter()
            index.search(qv, kk)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if r:                         # the first is a warm-up
                layers.setdefault(f"encode_b{b}_ms", []).append(
                    (t2 - t1) * 1e3)
                layers.setdefault(f"search_b{b}_ms", []).append(
                    (t3 - t2) * 1e3)
    layers = {k: statistics.median(v) for k, v in layers.items()}

    # Each kernel against its twin at the search path's shapes.
    sel_tiles = torch.tensor(sorted({s // TILE for s, _ in runs})[:32],
                             dtype=torch.int32, device=dev)
    recs = hold_calls(K_, T_, dense_calls(qb, emb, index.size, TILE,
                                          sel_tiles, kk), 3, "slice_f32")
    emit({"phase": "slice_f32", "rows": index.size, "dim": DIM,
          "encoder": {"layers": cfg.num_layers, "hidden": cfg.hidden_dim,
                      "heads": cfg.num_heads, "vocab": cfg.vocab_size,
                      "max_len": svc.max_len},
          "chunks": len(chunks), "runs": len(runs), **rounds,
          "launches_by_path": paths, "certified_alone": n_cert,
          "layers": layers, "forced_uncovered": uncovered,
          "fill_seconds": t_fill, "seconds": time.perf_counter() - t0})
    del small, res, qb, q, emb
    torch.cuda.empty_cache()
    return svc, index, paths, recs, sel_tiles


def phase_slice_bf16(K_, T_, dev, svc, index32, queries, sel_tiles):
    from optimized_rag_tpu_torch.index.dense import DenseIndex
    t0 = time.perf_counter()
    index = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.bfloat16, device=dev)
    emb32 = index32.embeddings()
    for lo in range(0, index32.size, 1 << 20):
        index.add(emb32[lo:min(index32.size, lo + (1 << 20))])
    del emb32
    torch.cuda.empty_cache()
    q = unit(torch.from_numpy(svc.encode(queries[0][:64])).to(dev))
    emb = index.embeddings()

    paths = {}
    res = counted(K_, paths, "search", lambda: index.search(q, K))
    small = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.bfloat16, device=dev)
    small.add(emb[:N_SMALL])
    res_small = counted(K_, paths, "small_index", lambda: small.search(q, K))
    require_launched(paths, USER_PATHS_BF16, FLOAT_KERNELS, "bf16")

    for idx, r in ((index, res), (small, res_small)):
        # The plain pipeline: bf16 scan, top-40, f32 rescore, top-10.
        _, cand = oracle_topk(q, idx.embeddings(), idx.size, 4 * K,
                              scan_dtype=torch.bfloat16)
        cand = cand.sort(dim=1).values       # exact ties to the lower row
        rows = idx.embeddings()[cand].float()
        s = (rows * q[:, None, :]).sum(-1)
        s, pos = torch.sort(s, dim=1, descending=True, stable=True)
        want_s, want_i = s[:, :K], torch.gather(cand, 1, pos[:, :K])
        check_answers(f"bf16 index of {idx.size} rows",
                      torch.from_numpy(r.ids).to(dev),
                      torch.from_numpy(r.scores).to(dev), want_i, want_s)
    # The bf16 scan's certified answers (k = 4 x 10, as search asks), one
    # query at a time, against the bf16-scan oracle.
    n_cert = counted(K_, paths, "certified_alone", lambda: certified_alone(
        T_, q, emb, index.size, 4 * K, torch.bfloat16))
    recs = hold_calls(K_, T_, dense_calls(q, emb, index.size, TILE,
                                          sel_tiles, 4 * K), 3, "slice_bf16")
    emit({"phase": "slice_bf16", "rows": index.size,
          "gbytes": index.size * DIM * 2 / 1e9, "B": q.shape[0],
          "launches_by_path": paths, "certified_alone": n_cert,
          "seconds": time.perf_counter() - t0})
    del index, small, emb, q
    torch.cuda.empty_cache()
    return paths, recs


class RouteLog:
    """The index as QueryServer sees it, recording each batch it searches:
    the query rows as the server passed them and the route they took."""

    def __init__(self, index):
        self.index = index
        self.batches = []
        self._lock = threading.Lock()

    def search(self, q, k):
        res = self.index.search(q, k)
        with self._lock:
            self.batches.append((np.array(q, dtype=np.float32), res.route))
        return res


def phase_slice_int8(K_, T_, dev, svc, chunks, queries):
    """int8 storage on the served path: 16,777,216 rows (4x the f32 slice's
    rows in the same bytes). Every answer is held against the oracle of the
    route its batch took; recall@10 against the f32 oracle of the
    unquantized rows is printed, not gated."""
    from optimized_rag_tpu_torch.index.dense import DenseIndex
    from optimized_rag_tpu_torch.ops.quantize import quantize_int8
    from optimized_rag_tpu_torch.ops.similarity import normalize
    from optimized_rag_tpu_torch.serving import QueryServer
    t0 = time.perf_counter()
    texts = queries[0] + queries[1]
    with svc._cache_lock:                 # fresh encodes, as in slice_f32
        svc._cache.clear()
    q32 = unit(torch.from_numpy(svc.encode(texts)).to(dev))
    f32 = {"s": torch.full((len(texts), K), float("-inf"), device=dev),
           "i": torch.full((len(texts), K), -1, dtype=torch.long,
                           device=dev), "rows": 0}
    index = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.int8, device=dev)

    def on_block(x, start):
        # quantize_int8 on the card equals its CPU result bit for bit, and
        # add stored exactly quantize_int8(normalize(rows)).
        u = normalize(x.float())
        c8, cs = quantize_int8(u)
        h8, hs = quantize_int8(u.cpu())
        if not (torch.equal(c8.cpu(), h8)
                and torch.equal(cs.cpu().view(torch.int32),
                                hs.view(torch.int32))):
            raise AssertionError(f"quantize_int8 on the card differs from "
                                 f"the CPU's in rows {start}..")
        n = x.shape[0]
        if not (torch.equal(index.embeddings()[start:start + n], c8)
                and torch.equal(index.row_scale[start:start + n], cs)):
            raise AssertionError(f"DenseIndex.add stored other codes than "
                                 f"quantize_int8(normalize(rows)) at {start}")
        # The f32 oracle of the unquantized rows, for recall.
        cand_s = torch.cat([f32["s"], q32 @ u.T], dim=1)
        cand_i = torch.cat([f32["i"], torch.arange(
            start, start + n, device=dev).expand(len(texts), -1)], dim=1)
        f32["s"], pos = torch.topk(cand_s, K, dim=1)
        f32["i"] = torch.gather(cand_i, 1, pos)
        f32["rows"] += n

    runs = fill_index(index, svc, chunks, dev, N_INT8, on_block)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    with svc._cache_lock:
        svc._cache.clear()
    index.search(svc.encode(["warm-up request"]), K)
    emb, scale = index.embeddings(), index.row_scale

    paths, rounds, logs = {}, {}, {}
    for name, burst, texts_r in (("served_burst", 8, queries[0]),
                                 ("served_closed_loop", 1, queries[1])):
        log = RouteLog(index)
        answers, lat, wall, stats = counted(
            K_, paths, name,
            lambda: drive_server(QueryServer, svc, log, texts_r, burst))
        lat_ms = sorted(x * 1e3 for x in lat)
        routes = [r for _, r in log.batches]
        rounds[name] = {
            "queries": len(texts_r), "clients": N_CLIENTS, "burst": burst,
            "qps": len(texts_r) / wall, "p50_ms": statistics.median(lat_ms),
            "p99_ms": lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))],
            "batches": stats["batches"], "avg_batch": stats["avg_batch"],
            "routes": {r: routes.count(r) for r in sorted(set(routes))},
            "launches": paths[name],
            "launches_per_batch": {k: v / stats["batches"]
                                   for k, v in paths[name].items()}}
        logs[name] = (log, answers, texts_r)

    # Direct DenseIndex.search of 64 queries, and a 131,072-row int8 index
    # (128 tiles < 64 * 40: the tiled K7 search alone).
    q64_raw = svc.encode(queries[0][:64])
    res64 = counted(K_, paths, "search", lambda: index.search(q64_raw, K))
    small = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.int8, device=dev)
    small.add(index.vectors_f32(N_SMALL))
    res_small = counted(K_, paths, "small_index",
                        lambda: small.search(q64_raw, K))
    if paths["small_index"] != {**dict.fromkeys(K_.KERNELS, 0),
                                "tile_topk_scaled": 1}:
        raise AssertionError(f"small int8 index did not route to K7 alone: "
                             f"{paths['small_index']}")
    require_launched(paths, USER_PATHS_INT8, INT8_KERNELS, "int8")

    # Every answer against the oracle of its route. The queries as the
    # index normalised them: each batch as it was searched.
    batches = [(name, qraw, route) for name, (log, _, _) in logs.items()
               for qraw, route in log.batches]
    batches.append(("search", q64_raw, res64.route))
    qn = [normalize(torch.from_numpy(qraw).to(dev).float())
          for _, qraw, _ in batches]
    qn_all = torch.cat(qn)
    h8, hs = quantize_int8(qn_all.cpu())
    q8, qs = quantize_int8(qn_all)
    if not (torch.equal(q8.cpu(), h8)
            and torch.equal(qs.cpu().view(torch.int32), hs.view(torch.int32))):
        raise AssertionError("quantize_int8 of the queries differs between "
                             "the card and the CPU")
    oracle = int8_oracle(qn_all, emb, scale, index.size, CC_SERVED + 1)
    held = {"certified": 0, "fallback": 0, "direct": 0}
    boundary = []
    lo = 0
    answers_by_row = {}          # query row's bytes -> its answers
    for name, (log, answers, texts_r) in logs.items():
        emb_r = svc.encode(texts_r)               # cache hits: same bytes
        for i, a in enumerate(answers):
            answers_by_row.setdefault(emb_r[i].tobytes(), []).append(a)
    for (name, qraw, route), qb in zip(batches, qn):
        m = qb.shape[0]
        orc = {r: (v[0][lo:lo + m], v[1][lo:lo + m])
               for r, v in oracle.items()}
        lo += m
        if name == "search":
            got_i = torch.from_numpy(res64.ids).to(dev)
            got_s = torch.from_numpy(res64.scores).to(dev)
            n_b = hold_route("int8 search of 64", route, got_i, got_s, orc,
                             qb, emb, scale, 4 * K, K)
            held[route] += m
        else:
            rows, got_i, got_s = [], [], []
            for r in range(m):
                # Pad rows repeat a query: its answers are taken once.
                for a in answers_by_row.pop(qraw[r].tobytes(), []):
                    rows.append(r)
                    got_s.append(a[0])
                    got_i.append(a[1])
            rows = torch.tensor(rows, device=dev)
            orc = {r: (v[0][rows], v[1][rows]) for r, v in orc.items()}
            n_b = hold_route(
                f"served int8 answers ({name})", route,
                torch.tensor(np.stack(got_i), device=dev),
                torch.tensor(np.stack(got_s), device=dev), orc, qb[rows],
                emb, scale, CC_SERVED, K_SERVED)
            held[route] += len(rows)
        if n_b:
            boundary.append({"batch": name, "route": route, "answers": n_b})
    if answers_by_row:
        raise AssertionError(f"{len(answers_by_row)} served answers were not "
                             "found in any searched batch")
    q_small = normalize(torch.from_numpy(q64_raw).to(dev).float())
    orc_small = int8_oracle(q_small, small.embeddings(), small.row_scale,
                            small.size, 4 * K + 1)
    n_small = hold_route("small int8 index", res_small.route,
                         torch.from_numpy(res_small.ids).to(dev),
                         torch.from_numpy(res_small.scores).to(dev),
                         orc_small, q_small, small.embeddings(),
                         small.row_scale, 4 * K, K)
    if n_small:
        boundary.append({"batch": "small_index", "route": res_small.route,
                         "answers": n_small})

    # Recall@10 of the served answers against the f32 oracle of the
    # unquantized rows (a quality reading, not a gate).
    recall = {}
    for j, (name, (_, answers, _)) in enumerate(logs.items()):
        hits = [len(set(a[1][:K].tolist())
                    & set(f32["i"][j * N_QUERIES + i].tolist()))
                for i, a in enumerate(answers)]
        recall[name] = sum(hits) / (K * len(hits))

    # 64 queries alone through the certified int8 search: each answer
    # whose certificate reads 0 must equal the exact int8-native oracle.
    q64 = qn[-1]
    m = q64.shape[0]
    o_s, o_i = oracle["certified"][0][-m:], oracle["certified"][1][-m:]

    def alone():
        certs = []
        for j in range(m):
            s_c, packed = T_.topk_certified(q64[j:j + 1], emb, CC_SERVED,
                                            index.size, tile=TILE,
                                            row_scale=scale)
            certs.append(T_.certificate_uncovered(packed))
            if certs[-1] == 0:
                if not (torch.equal(packed[:-1], o_i[j:j + 1, :CC_SERVED])
                        and torch.equal(s_c, o_s[j:j + 1, :CC_SERVED])):
                    check_answers(f"certified int8 answer {j}", packed[:-1],
                                  s_c, o_i[j:j + 1, :CC_SERVED],
                                  o_s[j:j + 1, :CC_SERVED], tol=0.0)
                    raise AssertionError(f"certified int8 answer {j}: scores "
                                         "not bit-equal to the oracle's")
        return certs
    certs = counted(K_, paths, "certified_alone", alone)
    if not certs.count(0):
        raise AssertionError("no int8 query certified alone")

    layers = {}
    for b in (64, 8):
        for r in range(4):
            t1 = time.perf_counter()
            qv = svc.encode([f"{t} (int8 {b}/{r})" for t in queries[0][:b]])
            t2 = time.perf_counter()
            index.search(qv, K_SERVED)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if r:
                layers.setdefault(f"encode_b{b}_ms", []).append(
                    (t2 - t1) * 1e3)
                layers.setdefault(f"search_b{b}_ms", []).append(
                    (t3 - t2) * 1e3)
    layers = {k: statistics.median(v) for k, v in layers.items()}

    sel_tiles = torch.tensor(sorted({s // TILE for s, _ in runs})[:32],
                             dtype=torch.int32, device=dev)
    recs = hold_calls(K_, T_, int8_calls(q64, emb, scale, index.size, TILE,
                                         sel_tiles, CC_SERVED), 3,
                      "slice_int8")
    emit({"phase": "slice_int8", "rows": index.size, "dim": DIM,
          "code_gbytes": index.size * DIM / 1e9,
          "scale_mbytes": index.size * 4 / 1e6, "runs": len(runs),
          "quantize_rows_checked": f32["rows"],
          "quantize_queries_checked": qn_all.shape[0], **rounds,
          "answers_held": held, "boundary_differences": boundary,
          "recall_at_10_vs_f32": recall,
          "certificates_alone": certs, "certified_alone": certs.count(0),
          "launches_by_path": paths, "layers": layers,
          "fill_seconds": t_fill, "seconds": time.perf_counter() - t0})
    del index, small, emb, scale, oracle, orc_small
    torch.cuda.empty_cache()
    return paths, recs


@contextlib.contextmanager
def with_twin_scan(T_, K_):
    """ops/topk.py with K1 replaced by its plain twin, on the card: the
    same pipeline without the scan kernel."""
    kernel = T_.packed_extract
    T_.packed_extract = lambda q, c, size, tile, groups=8, flag=None: \
        K_.packed_extract_plain(K_._scan_queries(q, c), c, size, tile, groups)
    try:
        yield
    finally:
        T_.packed_extract = kernel


@contextlib.contextmanager
def recording(T_, K_, log):
    """Each kernel wrapper that ops/topk.py calls (and ``K_.scan_floor``)
    appends (name, args) to ``log`` and launches as before."""
    saved = [(mod, name, getattr(mod, name)) for mod in (T_, K_)
             for name in K_.KERNELS if name in vars(mod)]

    def spy(name, fn):
        def call(*args):
            log.append((name, args))
            return fn(*args)
        return call
    for mod, name, fn in saved:
        setattr(mod, name, spy(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.int8: "int8"}


def call_shape(name, args):
    """What a kernel's time depends on: (dtype, B, N, D, tile, m, U)."""
    q, corpus, _, _, tile, m, tiles, _ = call_operands(name, args)
    return (DTYPE_NAMES[corpus.dtype], q.shape[0], *corpus.shape, tile, m,
            None if tiles is None else tiles.shape[0])


def shape_label(name, rec):
    """``B=.. tile=..`` and what m is: groups (scans), rounds over U tiles
    (covers) or tile_k."""
    m = ("" if name == "scan_floor"
         else f" groups={rec['m']}" if name.startswith("packed")
         else f" rounds={rec['m']} U={rec['U']}" if name.startswith("extract")
         else f" tile_k={rec['m']}")
    return f"B={rec['B']} tile={rec['tile']}{m}"


def hold_recorded(K_, T_, log, reps, where):
    """Hold one call of each distinct (kernel, shape) in ``log`` (path ->
    the (name, args) its run recorded) against its twin; each record
    carries how many launches of that shape every path made."""
    shapes = {}
    for path, calls in log.items():
        for name, args in calls:
            e = shapes.setdefault((name, *call_shape(name, args)),
                                  {"args": args, "by_path": {}})
            e["by_path"][path] = e["by_path"].get(path, 0) + 1
    out = []
    for key, e in shapes.items():
        name, dtype, b, _, _, tile, m, _ = key
        rec = hold_call(K_, T_, name, e.pop("args"), reps,
                        f"{where} {name} B={b} tile={tile} m={m}",
                        plain_reps=1)
        rec["shape"] = shape_label(name, rec)
        rec["fma_floor_ms"] = rec["flops"] / PEAK_F32 * 1e3
        out.append({"name": name, "dtype": dtype, "launches_by_path":
                    e["by_path"], **rec})
    log.clear()
    return out


def phase_bench_shape(K_, T_, dev):
    """The reference benchmark's retrieval path at its full shape
    (bench.py:180-265 and :540-575): 10,485,760 x 128 bf16 rows (the
    generator of benchmarks/common.py with 4,096 clusters, plus 300
    near-duplicate runs), tile 4096, k 10, unit-normal queries from a seed
    in batches of 1024 and 512. Every certified or verified answer with a
    certificate of 0 equals its route's oracle, and every other is rerun
    exactly and equals it too; ANN answers equal the same pipeline run with
    the scan's twin on the card, except for queries with a boundary word.
    Every kernel call the routes make is recorded; one call of each
    distinct shape is held against its twin and timed. Returns the
    launches of each path and those records, bf16 and int8 apart."""
    from optimized_rag_tpu_torch.ops.quantize import quantize_int8
    t0 = time.perf_counter()
    n, d, tile, k = N_BENCH, DIM_BENCH, BENCH_TILE, K
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    centers = torch.randn(4096, d, generator=gen, device=dev) * 2.0
    runs = plan_runs(random.Random(SEED + 2), n, 0, 300)
    corpus = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    block = 1 << 20
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        x = clustered_rows(hi - lo, gen, centers)
        for start, length in runs:             # 32-aligned: inside a block
            if lo <= start < hi:
                x[start - lo:start - lo + length] = near_duplicates(
                    x[start - lo], length, gen)
        corpus[lo:hi] = x.to(torch.bfloat16)
        del x
    del centers
    rng = np.random.default_rng(SEED)        # bench.py:195-203

    def qbatch(b):
        x = rng.standard_normal((b, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return torch.from_numpy(x).to(dev)
    q_head, q_cmp = qbatch(B_HEAD), qbatch(B_CMP)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    oracle = {B_HEAD: oracle_topk(q_head, corpus, n, k, torch.bfloat16),
              B_CMP: oracle_topk(q_cmp, corpus, n, k, torch.bfloat16)}
    paths, routes, log = {}, {}, {}

    def run(name, fn):
        """``fn()`` counted as path ``name``, its kernel calls recorded;
        the recorded calls must be exactly the counted launches."""
        calls = log.setdefault(name, [])
        with recording(T_, K_, calls):
            out = counted(K_, paths, name, fn)
        seen = {m: sum(c == m for c, _ in calls) for m in K_.KERNELS}
        if seen != paths[name]:
            raise AssertionError(f"bench_shape {name}: recorded {seen}, "
                                 f"counted {paths[name]}")
        return out

    def route(name, q, call, rerun, want, want_rerun=None, tol=TIE_TOL):
        """``call()`` -> (scores, ids with the certificate row), counted as
        path ``name`` together with the exact ``rerun()`` where the
        certificate is not 0; the answer held against its oracle (``want``,
        or ``want_rerun`` for a rerun answer); then ``call`` timed alone,
        and where the certificate was not 0 the rerun too (``rerun_ms``;
        ``path_ms`` is the two together)."""
        def path():
            s, packed = call()
            uncovered = T_.certificate_uncovered(packed)
            if uncovered:
                s, ids = rerun()
                return uncovered, s, ids
            return uncovered, s, packed[:-1]
        uncovered, s, ids = run(name, path)
        o_s, o_i = want_rerun if uncovered and want_rerun else want
        check_answers(f"bench_shape {name}", ids, s, o_i, o_s,
                      tol=TIE_TOL if uncovered else tol)
        ms = median_ms(call, 3)
        routes[name] = {"B": q.shape[0], "uncovered": uncovered,
                        "route": "fallback" if uncovered else "certified",
                        "ms": ms, "qps": q.shape[0] / ms * 1e3}
        if uncovered:          # what the failed certificate costs on top
            rerun_ms = median_ms(rerun, 3)
            routes[name].update(rerun_ms=rerun_ms, path_ms=ms + rerun_ms,
                                path_qps=q.shape[0] / (ms + rerun_ms) * 1e3)

    # 1. Certified at tile 4096, groups 8 (K1 -> K4; K6 on a nonzero
    # certificate), b1024, b512 and two sub-batches of 512.
    for name, q, call in (
            ("certified_b1024", q_head, lambda: T_.topk_certified(
                q_head, corpus, k, tile=tile, groups=GROUPS)),
            ("certified_b512", q_cmp, lambda: T_.topk_certified(
                q_cmp, corpus, k, tile=tile, groups=GROUPS)),
            ("certified_multi_2x512", q_head, lambda: T_.topk_certified_multi(
                q_head, corpus, k, sub_batch=B_CMP, tile=tile,
                groups=GROUPS))):
        route(name, q, call, lambda q=q: T_.tiled_topk(q, corpus, k,
                                                       tile=tile),
              oracle[q.shape[0]])

    # 2. ANN at oversample 32, b1024, against the same pipeline with the
    # scan's twin; K1's words held as in the kernel phase.
    ann = lambda: T_.topk_ann(q_head, corpus, k, tile=tile, groups=GROUPS,
                              oversample=32)
    a_s, a_i = run("ann_b1024", ann)
    with with_twin_scan(T_, K_):
        p_s, p_i = ann()
    qs = K_._scan_queries(q_head, corpus)
    w = K_.packed_extract(q_head, corpus, None, tile, GROUPS)
    w_p = K_.packed_extract_plain(qs, corpus, None, tile, GROUPS)
    faults, boundary = K_.packed_word_faults(qs, corpus, None, tile, w, w_p,
                                             drift=TIE_TOL, groups=GROUPS)
    on_boundary = (w != w_p).any(dim=1).any(dim=0)          # [B]
    del w, w_p
    differ = (a_i != p_i).any(dim=1) | (a_s != p_s).any(dim=1)
    if faults or bool((differ & ~on_boundary).any()):
        raise AssertionError(
            f"bench_shape ANN: {faults} faulty words; "
            f"{int((differ & ~on_boundary).sum())} answers differ from the "
            "twin pipeline's with no boundary word to explain them")
    recall = float(np.mean([
        len(set(a.tolist()) & set(o.tolist())) / k
        for a, o in zip(a_i.cpu(), oracle[B_HEAD][1].cpu())]))
    ms = median_ms(ann, 3)
    routes["ann_b1024"] = {
        "B": B_HEAD, "ms": ms, "qps": B_HEAD / ms * 1e3,
        "recall_at_10_vs_exact": recall,
        "answers_differing_from_twin_pipeline": int(differ.sum()),
        "queries_with_boundary_words": int(on_boundary.sum()),
        "boundary_words": boundary}

    # 3. Verified: per-query rescan at tile 1024, batch union at tile 4096.
    v_s, v_i = run("verified_b512", lambda: T_.topk_verified(
        q_cmp, corpus, k, tile=1024, tile_k=2))
    check_answers("bench_shape verified_b512", v_i, v_s, oracle[B_CMP][1],
                  oracle[B_CMP][0])
    ms = median_ms(lambda: T_.topk_verified(q_cmp, corpus, k, tile=1024,
                                            tile_k=2), 3)
    routes["verified_b512"] = {"B": B_CMP, "tile": 1024, "ms": ms,
                               "qps": B_CMP / ms * 1e3}
    route("verified_batch_b512", q_cmp,
          lambda: T_.topk_verified_batch(q_cmp, corpus, k, tile=tile,
                                         tile_k=2, union_tiles=32),
          lambda: T_.tiled_topk(q_cmp, corpus, k, tile=tile), oracle[B_CMP])

    # 5 (before the int8 copy). F over the bf16 rows at b1024: each tile's
    # best score; the best of all equals the oracle's top score.
    f = run("floor_b1024", lambda: K_.scan_floor(q_head, corpus, tile))
    top_err = float((f.amax(dim=0)[0] - oracle[B_HEAD][0][:, 0]).abs().max())
    if not top_err <= TIE_TOL:
        raise AssertionError(f"bench_shape floor: {top_err:.3g} from the "
                             "oracle's best score")
    del f
    bf16_paths = tuple(log)
    require_launched(paths, bf16_paths, FLOAT_KERNELS + ("scan_floor",),
                     "bench_shape bf16")
    held16 = hold_recorded(K_, T_, log, 3, "bench_shape bf16")

    # 4. The same rows as int8 codes, quantized on the card in blocks.
    c8 = torch.empty((n, d), dtype=torch.int8, device=dev)
    cs = torch.empty(n, device=dev)
    for lo in range(0, n, block):
        c8[lo:lo + block], cs[lo:lo + block] = quantize_int8(
            corpus[lo:lo + block].float())
    del corpus
    torch.cuda.empty_cache()
    q8, q8s = quantize_int8(q_head)
    q8f, qb = q8.float(), q_head.to(torch.bfloat16).float()
    native = running_topk(lambda lo, hi: ((q8f @ c8[lo:hi].float().T)
                                          * cs[lo:hi]) * q8s[:, None],
                          n, k, B_HEAD, dev)
    scaled = running_topk(lambda lo, hi: (qb @ c8[lo:hi].float().T)
                          * cs[lo:hi], n, k, B_HEAD, dev)
    fallback = lambda: T_.tiled_topk(q_head, c8, k, tile=tile, row_scale=cs)
    route("int8_native_b1024", q_head,
          lambda: T_.topk_certified_multi(
              q_head, c8, k, sub_batch=B_HEAD, tile=tile, groups=GROUPS,
              union_tiles=64, pad_r=26, row_scale=cs, int8_native=True),
          fallback, native, want_rerun=scaled, tol=0.0)
    route("int8_scaled_b1024", q_head,
          lambda: T_.topk_certified(q_head, c8, k, tile=tile, groups=GROUPS,
                                    row_scale=cs, int8_native=False),
          fallback, scaled)
    del q8, q8f, qb, native, scaled, oracle
    int8_paths = tuple(p for p in log)
    require_launched(paths, int8_paths, (
        "packed_extract_int8", "extract_int8", "packed_extract_scaled",
        "extract_scaled"), "bench_shape int8")
    held8 = hold_recorded(K_, T_, log, 3, "bench_shape int8")
    del c8, cs
    torch.cuda.empty_cache()

    emit({"phase": "bench_shape", "rows": n, "dim": d, "tile": tile,
          "k": k, "gbytes": n * d * 2 / 1e9,
          "int8_gbytes": n * (d + 4) / 1e9, "runs": len(runs),
          "routes": routes, "launches_by_path": paths,
          "fill_seconds": t_fill, "seconds": time.perf_counter() - t0})
    for rec in held16 + held8:
        emit({"phase": "bench_shape", "kernel": rec["name"],
              **{key: v for key, v in rec.items() if key != "name"}})
    return ({p: paths[p] for p in bf16_paths}, held16,
            {p: paths[p] for p in int8_paths}, held8)


# ---------------------------------------------------------- slice_hybrid

N_HYBRID = 262_144                # chunks of the hybrid slice (2**18)
FILLER_WORDS = 40                 # words of each seeded filler chunk
INGEST_BATCH = 128                # EmbeddingService.encode batch at ingest
N_HYBRID_QUERIES = 64
TOP_K, CANDIDATE_K, HALF_LIFE = 10, 50, 30.0
N_DELETED = 16                    # k = 50 + 16 stays within the kernels' 128
K_MMR, LAM = 5, 0.7
HYBRID_TOL = 1e-5                 # fused, semantic, BM25 (relative) scores
TEMPORAL_TOL = 1e-4               # now read in float32 days may step 2^-9
LOGIT_ATOL = 0.35                 # tests/test_torch_rerank.py, bf16 trunk
HYBRID_KERNEL_PATHS = ("dense_only_k2", "dense_only_k10", "tombstones")


def hybrid_corpus(chunks, n):
    """The qa_docs chunks, then seeded filler chunks of FILLER_WORDS words
    drawn from the chunks' own words, up to ``n``."""
    words = [w for c in chunks for w in c.split()]
    rng = random.Random(SEED + 3)
    return chunks + [" ".join(rng.choices(words, k=FILLER_WORDS))
                     for _ in range(n - len(chunks))]


def _top(scores, k):
    """Top-k of a float64 vector, ties to the lower index: (ids, scores).
    Candidates at or above the k-th value, in id order, then a stable
    sort."""
    k = min(k, scores.shape[0])
    kth = np.partition(scores, scores.shape[0] - k)[scores.shape[0] - k]
    cand = np.flatnonzero(scores >= kth)
    ids = cand[np.argsort(-scores[cand], kind="stable")[:k]]
    return ids, scores[ids]


class HybridOracle:
    """The hybrid query in float64 numpy, from the arrays LexicalIndex.build
    made (copied to the host), the index's rows and the query vectors the
    card computed: champion-list BM25, exact dense scores, the union of the
    two top-50 lists, min-max per channel over the union, the weighted blend
    and the top-k. The query's champion rows come from the index's host
    analyzer (``encode_query``); nothing computed on the card is reused."""

    def __init__(self, lexical, index, q_embs):
        d = lexical._device
        host = lambda t: t.cpu().numpy()
        self.lexical = lexical
        self.docs, self.valid = host(d["champ_docs"]), host(d["champ_valid"])
        self.tf = host(d["champ_tf"]).astype(np.float64)
        self.idf = host(d["idf"]).astype(np.float64)
        self.dlen = host(d["doc_len"]).astype(np.float64)
        self.avg = float(d["avg_len"])
        self.k1, self.b = lexical.k1, lexical.b
        self.size = index.size
        rows = index.embeddings()[:index.size].cpu().numpy().astype(
            np.float64)
        self.sem = rows @ np.asarray(q_embs, np.float64).T      # [N, Q]
        self.dead: list[int] = []

    def delete(self, rows):
        """Deleted rows are zeroed: they score 0 and leave the dense
        ranking."""
        self.dead = list(rows)
        self.sem[self.dead] = 0.0

    def bm25(self, text):
        q, v = self.lexical.encode_query(text)
        acc = np.zeros(self.size)
        for t in q[v]:                     # a document once per row
            m = self.valid[t]
            docs, tf = self.docs[t][m], self.tf[t][m]
            acc[docs] += self.idf[t] * tf * (self.k1 + 1.0) / (
                tf + self.k1 * (1.0 - self.b + self.b * self.dlen[docs]
                                / self.avg))
        return acc

    def dense(self, j):
        """(scores [N], the same with deleted rows at -inf) of query j."""
        sem = self.sem[:, j].copy()
        rank = sem.copy()
        rank[self.dead] = -np.inf
        return sem, rank

    def hybrid(self, j, text, ages_of, weights):
        """The fused top-k ids of query j, each union candidate's (fused,
        semantic, BM25, temporal) scores, and the gaps at the channels'
        50th candidates (dense absolute, BM25 relative)."""
        sem, rank = self.dense(j)
        d_ids, d_s = _top(rank, CANDIDATE_K + 1)
        b_ids, b_s = _top(self.bm25(text), CANDIDATE_K + 1)
        kw = {int(i): float(s) for i, s in zip(b_ids[:CANDIDATE_K],
                                                b_s[:CANDIDATE_K]) if s > 0}
        cand = np.array(sorted(set(d_ids[:CANDIDATE_K].tolist()) | set(kw)))
        chans = np.stack([sem[cand], [kw.get(int(c), 0.0) for c in cand],
                          np.exp2(-ages_of(cand) / HALF_LIFE)])
        lo, hi = chans.min(axis=1, keepdims=True), chans.max(
            axis=1, keepdims=True)
        normed = np.where(hi - lo < 1e-9, 0.5, (chans - lo) / np.maximum(
            hi - lo, 1e-9))
        w = np.asarray(weights, np.float64)
        fused = (normed * (w / w.sum())[:, None]).sum(axis=0)
        pos, _ = _top(fused, TOP_K)
        return {"ids": cand[pos].tolist(),
                "of": {int(c): (f, *ch) for c, f, ch in zip(
                    cand, fused, chans.T)},
                "dense_gap": float(d_s[CANDIDATE_K - 1] - d_s[CANDIDATE_K]),
                "bm25_gap": float((b_s[CANDIDATE_K - 1] - b_s[CANDIDATE_K])
                                  / max(b_s[CANDIDATE_K - 1], 1e-30))}


def hold_hybrid(what, docs, want, counts):
    """A route's answer against the oracle's: ids equal, and each doc's
    fused, semantic, BM25 (relative) and temporal scores within their
    tolerances of the oracle's for that doc. Differing ids are allowed
    only where the oracle shows a near-tie of HYBRID_TOL in the fused
    score, or at a channel's 50th candidate; such differences are counted.
    Returns the worst fused error."""
    ids, of = [d.doc_id for d in docs], want["of"]
    if ids != want["ids"]:
        if min(want["dense_gap"], want["bm25_gap"]) <= HYBRID_TOL:
            counts["channel_boundary"] += 1
            return 0.0
        if len(ids) != len(want["ids"]) or any(
                i not in of or abs(of[i][0] - of[w][0]) > HYBRID_TOL
                for i, w in zip(ids, want["ids"])):
            raise AssertionError(
                f"slice_hybrid {what}: ids {ids} differ from the oracle's "
                f"{want['ids']} with no near-tie to explain them")
        counts["near_tie"] += 1
    got = np.array([(d.score, d.semantic_score, d.keyword_score,
                     d.temporal_score) for d in docs])
    ref = np.array([of[i] for i in ids])
    err = np.abs(got - ref)
    err[:, 2] /= np.maximum(np.abs(ref[:, 2]), 1.0)
    bad = dict(zip(("fused", "sem", "kw", "tmp"), err.max(axis=0).tolist()))
    tol = {"fused": HYBRID_TOL, "sem": HYBRID_TOL, "kw": HYBRID_TOL,
           "tmp": TEMPORAL_TOL}
    over = {k: v for k, v in bad.items() if not v <= tol[k]}
    if over:
        raise AssertionError(f"slice_hybrid {what}: scores off the "
                             f"oracle's: {over} (tolerances {tol})")
    return bad["fused"]


def hold_dense_only(what, docs, oracle, j, k, counts):
    """dense_only's answer to query j against the exact float64 top-k, ties
    to the lower row; a differing id must score within HYBRID_TOL of the
    oracle's score at its rank (a near-tie), and is counted."""
    sem, rank = oracle.dense(j)
    o_ids, o_s = _top(rank, k)
    ids = np.array([d.doc_id for d in docs])
    vals = np.array([d.score for d in docs])
    if len(ids) != k:
        raise AssertionError(f"slice_hybrid {what}: {len(ids)} of {k} docs")
    if (ids != o_ids).any():
        if np.abs(sem[ids] - o_s).max() > HYBRID_TOL:
            raise AssertionError(f"slice_hybrid {what}: ids {ids.tolist()} "
                                 f"differ from the oracle's {o_ids.tolist()}")
        counts["near_tie"] += 1
    err = float(np.abs(vals - o_s).max())
    if not err <= HYBRID_TOL:
        raise AssertionError(f"slice_hybrid {what}: scores off by {err:.3g}")
    return err


def mmr_oracle(embs, blended, n, k):
    """FusedRerankEval's selection in float64: candidates padded to the
    bucket, sorted by blended score (ties to the lower index), greedy MMR
    over the sorted list. Returns (selected indices, each step's best and
    second-best objective)."""
    npad = next(b for b in (8, 16, 32) if n <= b)
    e = np.zeros((npad, embs.shape[1]))
    e[:n] = embs
    e /= np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    bm = np.full(npad, -1e30)
    bm[:n] = blended
    order = np.argsort(-bm, kind="stable")
    es, rel, ok = e[order], bm[order], order < n
    sim = es @ es.T
    chosen, steps, max_sim = [], [], np.full(npad, -1e30)
    for _ in range(min(k, npad)):
        pen = max_sim if chosen else np.zeros(npad)
        obj = np.where(ok, LAM * rel - (1.0 - LAM) * pen, -1e30)
        obj[chosen] = -1e30
        j = int(np.argmax(obj))
        if obj[j] <= -1e29:
            break
        steps.append(np.sort(obj)[-2:][::-1])
        chosen.append(j)
        max_sim = np.maximum(max_sim, sim[j])
    if n <= k:
        return [int(i) for i in order if i < n], steps
    return [int(order[j]) for j in chosen], steps


def device_busy(fn):
    """``fn()`` under torch.profiler: host-clock wall ms (synchronised), the
    device time of its kernels (one stream: they do not overlap), the idle
    share, and the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_ms = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) / 1e3
    # The kernels' own events: an operator's entry counts its kernels again.
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=dev_ms, reverse=True)
    busy = sum(dev_ms(e) for e in events)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall if busy else None,
            "top_kernels_ms": {e.key[:60]: dev_ms(e) for e in events[:5]}}


def route_stats(ms):
    ms = sorted(ms)
    return {"queries": len(ms), "p50_ms": statistics.median(ms),
            "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
            "mean_ms": statistics.fmean(ms)}


def phase_slice_hybrid(K_, T_, dev, svc, chunks, queries, smi):
    """The retrieval half of a chat turn at 262,144 chunks: ingest as the
    agent ingests (the pretrained BiEncoder embeds every chunk on the card
    in batches of 128 into a float32 DenseIndex at tile 1024; LexicalIndex
    with the agent's defaults); then 64 queries one at a time through the
    one-call and the two-call hybrid routes, dense_only at k=2 (certified:
    K1 -> K4) and k=10 (K6), FusedRerankEval on each one-call answer (modes
    ce and emb) beside the modular SelectiveReranker path, and the
    separate-dispatch route after 16 deletes (K6). Every answer is held
    against the float64 oracle; the cross-encoder's logits against the
    port's CPU run. Launch counts are set to 0 before each path and read
    after it. Resets the peak memory statistics. Returns the kernel
    records of the dense routes, each with its launches by path."""
    import dataclasses
    from optimized_rag_tpu_torch.engine.fused import FusedRerankEval
    from optimized_rag_tpu_torch.engine.rerank import SelectiveReranker
    from optimized_rag_tpu_torch.engine.retriever import HybridRetriever
    from optimized_rag_tpu_torch.engine.types import Intent, intent_weights
    from optimized_rag_tpu_torch.index.dense import DenseIndex
    from optimized_rag_tpu_torch.index.lexical import LexicalIndex
    from optimized_rag_tpu_torch.models.convert import load_crossencoder
    from optimized_rag_tpu_torch.ops import fused_query as FQ
    from optimized_rag_tpu_torch.ops.fused_eval import rerank_eval_fused
    from optimized_rag_tpu_torch.ops.hybrid import (
        bm25_channel, dense_channel, score_candidates)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ckpt = os.path.join(HERE, "checkpoints", "pretrained")
    texts = hybrid_corpus(chunks, N_HYBRID)
    created = (time.time() - np.random.default_rng(SEED + 3).random(
        N_HYBRID) * 365 * 86400).tolist()
    created32 = np.asarray([c / 86400.0 for c in created], np.float32)

    # Ingest: encode in batches of 128 into the DenseIndex, then the
    # lexical index (add, then build).
    with svc._cache_lock:
        svc._cache.clear()
    index = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.float32, device=dev)
    t1 = time.perf_counter()
    for lo in range(0, N_HYBRID, INGEST_BATCH):
        index.add(svc.encode(texts[lo:lo + INGEST_BATCH]))
    torch.cuda.synchronize()
    t_embed = time.perf_counter() - t1
    lexical = LexicalIndex(device=dev)
    t1 = time.perf_counter()
    lexical.add(texts)
    t_lex_add = time.perf_counter() - t1
    t1 = time.perf_counter()
    lexical.build()
    torch.cuda.synchronize()
    t_lex_build = time.perf_counter() - t1
    ce = load_crossencoder(ckpt, device=dev)
    with svc._cache_lock:                 # queries miss, as a user's would
        svc._cache.clear()

    mk = lambda encoder: HybridRetriever(
        index, lexical, svc.encode, get_text=texts.__getitem__,
        get_created_at=created.__getitem__, half_life_days=HALF_LIFE,
        candidate_k=CANDIDATE_K, encoder=encoder)
    one_call, two_call = mk(svc), mk(None)
    for r in (one_call, two_call):        # warm-up, not timed or held
        r.retrieve("warm-up request", TOP_K, Intent.QUESTION_ANSWERING)
        svc._cache.pop("warm-up request", None)
    w_qa = np.asarray(intent_weights(Intent.QUESTION_ANSWERING), np.float32)
    paths, log, times, counts, nows = {}, {}, {}, {}, [0.0] * len(queries)

    def drive(name, fn, record=False):
        """``fn(j, text)`` for every query, launches counted over the whole
        path (and, with ``record``, every kernel call recorded); host-clock
        ms per query. Returns the answers."""
        calls = log.setdefault(name, [])
        out, ms = [], []
        with recording(T_, K_, calls) if record else contextlib.nullcontext():
            K_.reset_launch_counts()
            for j, text in enumerate(queries):
                t_q = time.perf_counter()
                out.append(fn(j, text))
                ms.append((time.perf_counter() - t_q) * 1e3)
            paths[name] = K_.launch_counts()
        seen = {m: sum(c == m for c, _ in calls) for m in K_.KERNELS}
        if record and seen != paths[name]:
            raise AssertionError(f"slice_hybrid {name}: recorded {seen}, "
                                 f"counted {paths[name]}")
        times[name] = route_stats(ms)
        return out

    def hybrid(retriever, **kw):
        """A hybrid query at question_answering's weights; the oracle
        reads now just before the call."""
        def ask(j, text):
            nows[j] = time.time()
            return retriever.retrieve(text, TOP_K, Intent.QUESTION_ANSWERING,
                                      **{k: v[j] for k, v in kw.items()})
        return ask

    def host_ages(j):
        """The separate routes' ages: float64 seconds on the host, then
        float32 days."""
        return lambda c: np.asarray([np.float32(
            (nows[j] - created[i]) / 86400.0) for i in c], np.float64)

    def hold_route(name, answers, ages_of):
        counts[name] = {"near_tie": 0, "channel_boundary": 0}
        return max(hold_hybrid(f"{name} query {j}", answers[j],
                               oracle.hybrid(j, text, ages_of(j), w_qa),
                               counts[name])
                   for j, text in enumerate(queries))

    # (a) The one-call route; the query vectors ride back in the packed
    # result's row 5 into the encoder's cache. The one-call route's ages
    # are float32 days on the card: now, rounded to float32, minus each
    # row's float32 days.
    answers_a = drive("one_call", hybrid(one_call))
    q_emb = np.stack([svc._cache[text] for text in queries])
    oracle = HybridOracle(lexical, index, q_emb)
    err_a = hold_route("one_call", answers_a, lambda j: lambda c: np.maximum(
        np.float64(np.float32(nows[j] / 86400.0))
        - created32[c].astype(np.float64), 0.0))

    # The device's busy and idle time over 16 one-call queries (under the
    # profiler, which adds host time).
    trace = device_busy(lambda: [one_call.retrieve(
        text, TOP_K, Intent.QUESTION_ANSWERING) for text in queries[:16]])

    # (b) The two-call route on (a)'s query vectors: the same answers.
    answers_b = drive("two_call", hybrid(two_call, query_embedding=q_emb))
    err_b = hold_route("two_call", answers_b, host_ages)
    for j, (a, b) in enumerate(zip(answers_a, answers_b)):
        if [d.doc_id for d in a] != [d.doc_id for d in b] or max(
                abs(x.score - y.score) for x, y in zip(a, b)) > HYBRID_TOL:
            raise AssertionError(f"slice_hybrid query {j}: the one-call and "
                                 "two-call routes answer differently")

    # (c) dense_only (use_hybrid=False intents) through DenseIndex.search:
    # k=2 takes the certified path (K1 -> K4), k=10 the tiled search (K6).
    for name, k, intent in (("dense_only_k2", 2, Intent.CONVERSATIONAL),
                            ("dense_only_k10", 10, Intent.SUMMARIZATION)):
        got = drive(name, lambda j, text, k=k, intent=intent:
                    one_call.retrieve(text, k, intent), record=True)
        counts[name] = {"near_tie": 0}
        for j in range(len(queries)):
            hold_dense_only(f"{name} query {j}", got[j], oracle, j, k,
                            counts[name])

    # (e) FusedRerankEval on each one-call answer, modes ce and emb, beside
    # the modular SelectiveReranker.rerank -> apply_mmr on the same docs.
    # The answers' texts are embedded first, so both paths find them in the
    # cache (stage "embed_10_texts" times that forward), and each path runs
    # once untimed on the warm-up answer (the first forward of a shape pays
    # for the library's set-up).
    mk_rr = lambda: SelectiveReranker(cross_encoder=ce, embed_fn=svc.encode,
                                      device=dev)
    copy = lambda docs: [dataclasses.replace(d) for d in docs]
    svc.encode([d.text for docs in answers_a for d in docs])
    warm = one_call.retrieve("warm-up request", TOP_K,
                             Intent.QUESTION_ANSWERING)
    for intent in (Intent.QUESTION_ANSWERING, Intent.SEARCH):
        rr = mk_rr()
        FusedRerankEval(rr, svc.encode, cross_encoder=ce).run(
            "warm-up request", copy(warm), intent, k_mmr=K_MMR, lam=LAM)
        rr.apply_mmr(rr.rerank("warm-up request", copy(warm), intent),
                     k=K_MMR, lam=LAM)
    fe = FusedRerankEval(mk_rr(), svc.encode, cross_encoder=ce)
    for mode, intent in (("ce", Intent.QUESTION_ANSWERING),
                         ("emb", Intent.SEARCH)):
        def fused(j, text, intent=intent):
            docs = copy(answers_a[j])
            return fe.run(text, docs, intent, k_mmr=K_MMR, lam=LAM), docs
        runs = drive(f"fused_eval_{mode}", fused)
        rr = mk_rr()
        modular = drive(f"modular_{mode}", lambda j, text, intent=intent,
                        rr=rr: rr.apply_mmr(rr.rerank(
                            text, copy(answers_a[j]), intent), k=K_MMR,
                            lam=LAM))
        counts[f"fused_eval_{mode}"] = {"mmr_near_tie": 0}
        for j, text in enumerate(queries):
            (res, docs), sel = runs[j], [d.doc_id for d in runs[j][0]["docs"]]
            if sel != [d.doc_id for d in modular[j]]:
                raise AssertionError(f"slice_hybrid {mode} query {j}: fused "
                                     f"{sel} != modular "
                                     f"{[d.doc_id for d in modular[j]]}")
            embs = svc.encode([text] + [d.text for d in docs])
            want, steps = mmr_oracle(embs[1:], [d.score for d in docs],
                                     len(docs), K_MMR)
            if sel != [docs[i].doc_id for i in want]:
                if not any(s[0] - s[1] <= HYBRID_TOL for s in steps):
                    raise AssertionError(f"slice_hybrid {mode} query {j}: "
                                         "MMR selection differs from the "
                                         "oracle's")
                counts[f"fused_eval_{mode}"]["mmr_near_tie"] += 1
                continue
            dn = embs[1:][want].astype(np.float64)
            dn /= np.maximum(np.linalg.norm(dn, axis=1, keepdims=True),
                             1e-12)
            qn = embs[0] / max(np.linalg.norm(embs[0]), 1e-12)
            rel = np.clip((dn @ qn + 1.0) / 2.0, 0.0, 1.0)
            bad = max(float(np.abs(np.asarray(res["per_doc"]) - rel).max()),
                      float(np.abs(res["sim"] - dn @ dn.T).max()))
            if not bad <= HYBRID_TOL:
                raise AssertionError(f"slice_hybrid {mode} query {j}: "
                                     f"relevance or sim off by {bad:.3g}")
    stats = fe.reranker.stats
    if stats["reranked"] != len(queries) or \
            stats["embedding_reranked"] != len(queries):
        raise AssertionError(f"slice_hybrid: fused routing {stats}")

    # The cross-encoder on the card against the port's CPU run of the same
    # pairs (8 queries x the first answer's docs).
    ce_cpu = load_crossencoder(ckpt, device="cpu")
    pairs = ce.tokenizer.encode_pairs(
        [(text, d.text) for text in queries[:8] for d in answers_a[0]],
        ce.max_len)
    logit_err = float(np.abs(ce.logits(*pairs).cpu().numpy()
                             - ce_cpu.logits(*pairs).numpy()).max())
    if not logit_err <= LOGIT_ATOL:
        raise AssertionError(f"slice_hybrid: cross-encoder logits on the "
                             f"card off the CPU's by {logit_err:.3g}")
    del ce_cpu

    # (d) 16 deletes (rows the one-call route answered): separate calls,
    # DenseIndex.search at k = 50 + 16 (K6), LexicalIndex.search, and
    # fuse_candidates. BM25 still finds deleted rows; their score is 0.
    dead = list(dict.fromkeys(d.doc_id for docs in answers_a
                              for d in docs))[:N_DELETED]
    index.delete(dead)
    oracle.delete(dead)
    answers_d = drive("tombstones", hybrid(one_call), record=True)
    err_d = hold_route("tombstones", answers_d, host_ages)
    require_launched(paths, ("dense_only_k2",), ("packed_extract", "extract"),
                     "slice_hybrid dense_only k=2")
    require_launched(paths, ("dense_only_k10",), ("tile_topk",),
                     "slice_hybrid dense_only k=10")
    require_launched(paths, ("tombstones",), ("tile_topk",),
                     "slice_hybrid tombstone")

    # Where a query's time goes on the card: each stage alone on the first
    # query's inputs, CUDA events.
    text, now_days = queries[0], time.time() / 86400.0
    q_ids, q_mask = svc.tokenizer.encode_batch([text], svc.max_len)
    dvc = lexical._device
    lex_args = (*lexical.query_tensors(text), dvc["champ_docs"],
                dvc["champ_tf"], dvc["champ_valid"], dvc["idf"],
                dvc["doc_len"], dvc["avg_len"])
    emb, size = index.embeddings(), index.size
    qv = FQ.encode_query_vector(svc.model, q_ids, q_mask)
    d_s, d_i = dense_channel(qv, emb, CANDIDATE_K, size)
    b_s, b_i = bm25_channel(*lex_args, CANDIDATE_K, size, 1.5, 0.75)
    created_dev = one_call._created_days()
    w_dev = torch.as_tensor(w_qa, device=dev)

    def fuse():
        cand, ok, kw = FQ.union_candidates(d_s[0], d_i[0], b_s, b_i)
        safe = cand.clamp_min(0)
        ages = torch.clamp_min(now_days - created_dev[safe], 0.0)
        return T_._topk(score_candidates(qv[0], emb, safe, kw, ages, ok,
                                         w_dev, HALF_LIFE)[0], TOP_K)
    docs0 = answers_a[0]
    n0 = len(docs0)
    pad = lambda a: np.pad(a, [(0, 16 - n0)] + [(0, 0)] * (a.ndim - 1))
    pairs0 = ce.tokenizer.encode_pairs([(text, d.text) for d in docs0],
                                       ce.max_len)
    e0 = svc.encode([text] + [d.text for d in docs0])
    texts0 = [d.text for d in docs0]

    def embed_texts():                    # cache misses, as at first sight
        with svc._cache_lock:
            svc._cache.clear()
        return svc.encode(texts0)
    stages = {
        "encoder_forward": lambda: FQ.encode_query_vector(svc.model, q_ids,
                                                          q_mask),
        f"embed_{n0}_texts": embed_texts,
        "dense_channel": lambda: dense_channel(qv, emb, CANDIDATE_K, size),
        "bm25_channel": lambda: bm25_channel(*lex_args, CANDIDATE_K, size,
                                             1.5, 0.75),
        "union_and_fusion": fuse,
        "encode_and_retrieve": lambda: FQ.encode_and_retrieve(
            svc.model, q_ids, q_mask, emb, size, *lex_args, created_dev,
            now_days, w_qa, HALF_LIFE, matryoshka_dim=None,
            candidate_k=CANDIDATE_K, k=TOP_K),
        f"ce_forward_{n0}_pairs": lambda: ce.logits(*pairs0),
        "rerank_eval_fused_ce": lambda: rerank_eval_fused(
            ce.model, *map(pad, pairs0), pad(e0[1:]), e0[0],
            pad(np.asarray([d.score for d in docs0], np.float32)),
            np.arange(16) < n0, 0.3, LAM, k_mmr=K_MMR, mode="ce",
            device=dev)}
    stage_ms = {name: median_ms(fn, 20) for name, fn in stages.items()}

    held = hold_recorded(K_, T_, {p: log[p] for p in HYBRID_KERNEL_PATHS},
                         5, "slice_hybrid")
    emit({"phase": "slice_hybrid", "card": smi, "chunks": index.size,
          "dim": DIM, "tile": TILE, "queries": len(queries),
          "top_k": TOP_K, "candidate_k": CANDIDATE_K, "deleted": len(dead),
          "lexical_terms": len(lexical._row_of),
          "champ_shape": list(dvc["champ_docs"].shape),
          "ingest_chunks_per_s": index.size / t_embed,
          "ingest_embed_seconds": t_embed,
          "lexical_add_seconds": t_lex_add,
          "lexical_build_seconds": t_lex_build,
          "routes_host_ms": times, "stages_cuda_ms": stage_ms,
          "one_call_trace_16_queries": trace,
          "oracle_max_fused_err": {"one_call": err_a, "two_call": err_b,
                                   "tombstones": err_d},
          "allowed_differences": counts, "ce_logit_err_vs_cpu": logit_err,
          "fused_eval_stats": stats, "launches_by_path": paths,
          "peak_device_gbytes": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})
    for rec in held:
        emit({"phase": "slice_hybrid", "card": smi, "kernel": rec["name"],
              **{key: v for key, v in rec.items() if key != "name"}})
    del index, lexical, oracle, one_call, two_call, ce, fe, emb, qv
    torch.cuda.empty_cache()
    return held


SOURCES = {"packed_extract": ("optimized_rag_tpu_torch/csrc/packed_extract.cu",
                              "optimized_rag_tpu/ops/topk.py:511"),
           "extract": ("optimized_rag_tpu_torch/csrc/extract.cu",
                       "optimized_rag_tpu/ops/topk.py:992"),
           "tile_topk": ("optimized_rag_tpu_torch/csrc/tile_topk.cu",
                         "optimized_rag_tpu/ops/topk.py:142"),
           "packed_extract_int8": (
               "optimized_rag_tpu_torch/csrc/packed_extract.cu",
               "optimized_rag_tpu/ops/topk.py:548"),
           "extract_int8": ("optimized_rag_tpu_torch/csrc/extract.cu",
                            "optimized_rag_tpu/ops/topk.py:1037"),
           "tile_topk_scaled": ("optimized_rag_tpu_torch/csrc/tile_topk.cu",
                                "optimized_rag_tpu/ops/topk.py:178"),
           "packed_extract_scaled": (
               "optimized_rag_tpu_torch/csrc/packed_extract.cu",
               "optimized_rag_tpu/ops/topk.py:530"),
           "extract_scaled": ("optimized_rag_tpu_torch/csrc/extract.cu",
                              "optimized_rag_tpu/ops/topk.py:1021"),
           # F ports F1 (replaces) and F2, benchmarks/sweep_r4c.py:157,
           # the same function.
           "scan_floor": ("optimized_rag_tpu_torch/csrc/floor.cu",
                          "benchmarks/sweep_r4_kernel.py:128")}


# The tensor-core scan: K1 and F over bf16/f16 rows, K2 over int8 codes and
# bf16 rows, K3.
MMA_SCAN_SOURCE = "optimized_rag_tpu_torch/csrc/scan_mma.cuh"
MMA_SCAN_ROWS = {"packed_extract": ("bf16", "f16"),
                 "scan_floor": ("bf16", "f16"),
                 "packed_extract_scaled": ("int8", "bf16"),
                 "packed_extract_int8": ("int8",)}


def kernel_entry(name, where, by_path, rec):
    """One entry of the final ``kernels`` line; the packed scans' and F's
    carry ``score_diff``, their largest score difference from the twin."""
    source, replaces = SOURCES[name]
    if where.split()[0] in MMA_SCAN_ROWS.get(name, ()):
        source = MMA_SCAN_SOURCE
    entry = {"name": f"{name}[{where}]", "route": "cuda", "source": source,
             "replaces": replaces, "launches": sum(by_path.values()),
             "launches_by_path": by_path,
             **{key: rec[key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")},
             "bound_share": rec["bound_ms"] / rec["ms"],
             "library_factor": rec["ms"] / rec["library_ms"]}
    if "score_diff" in rec:
        entry["score_diff"] = rec["score_diff"]
    if name == "scan_floor":
        entry["also_replaces"] = "benchmarks/sweep_r4c.py:157"
    return entry


FLOAT_KERNELS = ("packed_extract", "extract", "tile_topk")
INT8_KERNELS = ("packed_extract_int8", "extract_int8", "tile_topk_scaled")
USER_PATHS_F32 = ("served_burst", "served_closed_loop", "small_index")
USER_PATHS_BF16 = ("search", "small_index")
USER_PATHS_INT8 = ("served_burst", "served_closed_loop", "search",
                   "small_index")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card; none is visible")
    import optimized_rag_tpu_torch  # noqa: F401  (turns TF32 off)
    from optimized_rag_tpu_torch.ops import topk as T_
    from optimized_rag_tpu_torch.ops import topk_kernels as K_
    start_watchdog()
    kind, smi = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    phase_build()
    phase_kernels(K_, T_, dev)
    chunks = qa_chunks()
    first = make_queries(chunks, random.Random(SEED))
    queries = (first, make_queries(chunks, random.Random(SEED + 1),
                                   exclude=set(first)))
    svc, index32, paths32, recs32, sel_tiles = phase_slice_f32(
        K_, T_, dev, chunks, queries)
    paths16, recs16 = phase_slice_bf16(K_, T_, dev, svc, index32, queries,
                                       sel_tiles)
    del index32
    torch.cuda.empty_cache()
    paths8, recs8 = phase_slice_int8(K_, T_, dev, svc, chunks, queries)
    peak = torch.cuda.max_memory_allocated()   # slice_hybrid resets it
    held_h = phase_slice_hybrid(K_, T_, dev, svc, chunks,
                                first[:N_HYBRID_QUERIES], smi)
    del svc
    torch.cuda.empty_cache()
    bench16, held16, bench8, held8 = phase_bench_shape(K_, T_, dev)
    peak = max(peak, torch.cuda.max_memory_allocated())
    emit({"phase": "done", "peak_device_gbytes": peak / 1e9,
          "seconds": time.perf_counter() - _T0})
    if peak > MAX_DEVICE_BYTES:
        raise AssertionError(f"peak device memory {peak / 1e9:.1f} GB "
                             f"> {MAX_DEVICE_BYTES / 1e9:.0f} GB")
    # One entry per kernel and shape a user path gives it, its numbers
    # measured at that shape and its launches counted on those paths alone:
    # the served slices (QueryServer rounds and the small index for f32;
    # DenseIndex.search at both sizes for bf16; QueryServer rounds,
    # DenseIndex.search and the small index for int8), then every shape of
    # bench_shape's routes, then each shape slice_hybrid's dense routes gave
    # K1, K4 and K6. The direct calls of the checks are not counted.
    kernels = []
    for dtype, paths, user, recs in (
            ("f32", paths32, USER_PATHS_F32, recs32),
            ("bf16", paths16, USER_PATHS_BF16, recs16),
            ("int8", paths8, USER_PATHS_INT8, recs8)):
        for name, rec in recs.items():
            kernels.append(kernel_entry(name, f"{dtype}", {
                p: paths[p][name] for p in user}, rec))
    for rec in held16 + held8:
        kernels.append(kernel_entry(
            rec["name"], f"{rec['dtype']} bench_shape {rec['shape']}",
            rec["launches_by_path"], rec))
    for rec in held_h:
        kernels.append(kernel_entry(
            rec["name"], f"{rec['dtype']} slice_hybrid {rec['shape']}",
            rec["launches_by_path"], rec))
    idle = [k["name"] for k in kernels if not k["launches"]]
    missing = set(K_.KERNELS) - {k["name"].split("[")[0] for k in kernels}
    if idle or missing:
        raise AssertionError(f"never launched on a user path: {idle}; no "
                             f"entry: {sorted(missing)}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
