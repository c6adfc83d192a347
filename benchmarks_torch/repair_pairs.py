"""Time the certificate's repair at a benchmark cell's shape, on a card.

Builds a cell's corpus and index as ``portbench`` does, takes one batch of
the cell's queries (the batch cell: 4,096 vectors, searched for 4 x k
candidates over bf16 rows in sub-batches of 1,024; a served cell: 64 texts
through the encoder, searched for the server's bucket of k), runs the
certified search with its certificate deferred and then, with CUDA events,
each part alone: K4p (``extract_pairs``) on the covers' pairs, the whole
``repair_uncovered`` (the pairs' count, K4p, the merge) and the K6 rerun it
replaces. The kernel's own device time comes from the profiler
(``pair_topk_kernel``). Prints one JSON line per cell:

    python3 benchmarks_torch/repair_pairs.py --workload \
        mrl128.bf16-10m.batch-b4096 --seed 7 [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PEAK_BW = 3.35e12
PEAK = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}


def events_ms(fn, reps):
    """Median ms of ``fn`` over ``reps`` runs, each between CUDA events."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def kernel_ms(fn, name, reps):
    """Mean device ms a call of the kernels named ``name``, by the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if name in e.key)
    return us / reps / 1e3


def batch_queries(cell, system, seed):
    from portbench.traffic import batch
    load = batch.Load(system, cell.mix, seed)
    return load.pool[0], int(cell.mix["k"])


def served_queries(cell, system, seed):
    from portbench.traffic.served import TextStream
    texts = TextStream(cell.mix, seed, 10, set())
    q = system.svc.encode([next(texts) for _ in range(
        system.server.max_batch)])
    return (torch.as_tensor(q, device=system.device),
            system.server._bucket(int(cell.mix["k"])))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    from optimized_rag_tpu_torch.ops import topk as T
    from optimized_rag_tpu_torch.ops import topk_kernels as K
    from optimized_rag_tpu_torch.ops.similarity import normalize
    from portbench import harness
    from portbench import spans as spans_mod
    from portbench import system as system_mod

    dev = torch.device("cuda", 0)
    cell = harness.cell(harness.benchmark(), args.workload)
    system = system_mod.System(cell.cfg, args.seed, dev, spans_mod.Spans())
    index = system.index
    make = (batch_queries if cell.mix["generator"] == "batch"
            else served_queries)
    q, k = make(cell, system, args.seed)
    q = normalize(q.float())
    dtype = cell.cfg["index"]["dtype"]
    cc = 4 * k if dtype == "bfloat16" and index.size > 4 * k else k
    emb, size, tile = index.embeddings(), index.size, index.tile
    s, ids, cover = T.dispatch_deferred(q, emb, cc, size=size, tile=tile)
    uncovered = T.read_count(cover.count)
    need = cover.need
    pairs = need.T.nonzero()
    pt, pq = pairs[:, 0], pairs[:, 1]
    tiles_used = int(torch.unique(pt).numel())
    d = emb.shape[1]

    k4p = lambda: K.extract_pairs(q, emb, size, tile, cc, pt, pq)  # noqa
    repair = lambda: T.repair_uncovered(q, emb, cc, size, tile, s, ids,  # noqa
                                        cover)
    rerun = lambda: T.tiled_topk(q, emb, cc, size, tile=tile)  # noqa
    s2, i2, n_pairs, reran = repair()
    s_r, i_r = rerun()
    same_ids = float((i2 == i_r).float().mean())
    rec = {"workload": args.workload, "seed": args.seed, "B": q.shape[0],
           "cc": cc, "N": size, "D": d, "tile": tile, "dtype": dtype,
           "uncovered": uncovered, "pairs": n_pairs, "rerun": reran,
           "tiles_used": tiles_used,
           "max_pairs_a_tile": int(torch.bincount(pt).max()),
           "ids_equal_share": same_ids,
           "score_diff": float((s2 - s_r).abs().max()),
           "k4p_call_ms": events_ms(k4p, args.reps),
           "k4p_kernel_ms": kernel_ms(k4p, "pair_topk_kernel", args.reps),
           "repair_ms": events_ms(repair, args.reps),
           "rerun_ms": events_ms(rerun, max(3, args.reps // 4))}
    elt = emb.element_size()
    nbytes = tiles_used * tile * d * elt + n_pairs * d * 4 + n_pairs * cc * 8
    flops = 2.0 * n_pairs * tile * d
    t_b, t_o = nbytes / PEAK_BW * 1e3, flops / PEAK[dtype] * 1e3
    rec.update(bytes=nbytes, flops=flops, bound_ms=max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations")
    rec["bound_share"] = rec["bound_ms"] / rec["k4p_kernel_ms"]
    rec["device"] = torch.cuda.get_device_name(0)
    rec["power_limit"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
