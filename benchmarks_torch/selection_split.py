#!/usr/bin/env python3
"""Time the selection kernels at the served shapes under four cluster caps.

    python3 benchmarks_torch/selection_split.py      # needs one CUDA card

Where a launch gives fewer than 264 blocks, ``csrc/topk_common.cuh`` splits
each tile's rows over a thread-block cluster and merges the blocks' lists
in shared memory; ``kMaxSplit`` caps the cluster. The served union pass
(B=64, U=32 tiles of 1024 rows, D=384) gives 32 blocks. This script builds
the kernels with the cap at 1, 2, 4 and 8 (``-DORAG_MAX_SPLIT``) and times
K4 over f32 rows at 16 rounds and over bf16 rows at 40 (the f32 and bf16
searches), and K5b over int8 codes at 64 (the int8 search), each two ways:
one call between synchronisations (what a search waits for) and 20 calls
back to back (the device's own time). The builds run in the order 2, 1, 4,
8, 8, 4, 1, 2; each time is a CUDA-event median of 5 (back to back: the
mean of the 20). Prints one JSON line per kernel, then ptxas's registers
of the selection kernels per cap, then nvidia-smi's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

CAPS = (2, 1, 4, 8, 8, 4, 1, 2)
N, D, B, TILE, U = 4_194_304, 384, 64, 1024, 32
REPS, BACK_TO_BACK = 5, 20


def build(cap):
    """The kernels' library with the cluster capped at ``cap`` blocks;
    returns it and ptxas's register lines for the selection kernels."""
    from optimized_rag_tpu_torch.ops import _build
    saved = list(_build.COMPILE_FLAGS), _build.BUILD_DIR
    _build.COMPILE_FLAGS = saved[0] + [f"-DORAG_MAX_SPLIT={cap}"]
    _build.BUILD_DIR = os.path.join(HERE, "build", "selection_split")
    _build._lib = None
    try:
        if os.path.exists(_build._library_path(_build.find_nvcc())):
            os.remove(_build._library_path(_build.find_nvcc()))
        lib = _build.load_library()
        log = _build.build_info["ptxas"].splitlines()
    finally:
        _build.COMPILE_FLAGS, _build.BUILD_DIR = saved
        _build._lib = None
    regs, entry = [], None
    for line in log:
        if "Compiling entry" in line:
            entry = "stream_topk_kernel" in line and line.split("'")[1]
        elif entry and "Used" in line:
            regs.append(f"{entry}: {line.split(':', 1)[1].strip()}")
    return lib, regs


def times_ms(fn) -> tuple[float, float]:
    """(median of single calls, mean of calls back to back), in ms."""
    fn()
    torch.cuda.synchronize()
    one = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        one.append(a.elapsed_time(b))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(BACK_TO_BACK):
        fn()
    b.record()
    b.synchronize()
    return statistics.median(one), a.elapsed_time(b) / BACK_TO_BACK


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("selection_split needs a CUDA card")
    import optimized_rag_tpu_torch  # noqa: F401  (turns TF32 off)
    from optimized_rag_tpu_torch.ops import _build
    from optimized_rag_tpu_torch.ops import topk_kernels as K_
    from optimized_rag_tpu_torch.ops.quantize import quantize_int8
    dev = torch.device("cuda", 0)
    libs = {cap: build(cap) for cap in sorted(set(CAPS))}
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = torch.randn(N, D, generator=gen, device=dev)
    rows /= rows.norm(dim=1, keepdim=True)
    q = torch.randn(B, D, generator=gen, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    c16 = rows.to(torch.bfloat16)
    c8, cs = quantize_int8(rows)
    q8, qs = quantize_int8(q)
    tiles = torch.randperm(N // TILE, generator=gen, device=dev)[:U].to(
        torch.int32)
    kernels = (
        ("K4 f32, 16 rounds", lambda: K_.extract(q, rows, None, TILE, 16,
                                                 tiles)),
        ("K4 bf16, 40 rounds", lambda: K_.extract(q, c16, None, TILE, 40,
                                                  tiles)),
        ("K5b int8, 64 rounds", lambda: K_.extract_int8(
            q8, qs, c8, cs, None, TILE, 64, tiles)))
    for what, fn in kernels:
        one = {cap: [] for cap in libs}
        piped = {cap: [] for cap in libs}
        for cap in CAPS:
            _build._lib = libs[cap][0]
            a, b = times_ms(fn)
            one[cap].append(a)
            piped[cap].append(b)
        _build._lib = None
        print(json.dumps({
            "kernel": what, "B": B, "U": U, "tile": TILE, "D": D,
            "one_call_ms": {c: sum(v) / len(v) for c, v in one.items()},
            "back_to_back_ms": {c: sum(v) / len(v)
                                for c, v in piped.items()}}), flush=True)
    print(json.dumps({"ptxas_registers": {c: v[1] for c, v in libs.items()}}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
