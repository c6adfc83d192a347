#!/usr/bin/env python3
"""Time the packed scans K1, K2 and K3 and the scan floor F from two or
more copies of the package.

    python3 benchmarks_torch/scan_ab.py DIR [DIR ...]   # needs one CUDA card

Each DIR holds an ``optimized_rag_tpu_torch`` package (the repository
root, or an earlier commit unpacked with ``git archive``); its kernels
build into DIR's own ``build/``. Every copy is timed in a process of its
own, in turns (A, B, B, A), at the shapes the paths give the scans: the
reference benchmark's (10,485,760 x 128 rows, tile 4096, groups 8: K1 at
B=1024 and 512 and F at 1024 over bf16 rows; K2 and K3 at B=1024 over the
same rows as int8 codes) and the served ones (tile 1024, B=64: K1 over
4,194,304 x 384 bf16 rows, K3 over 16,777,216 x 384 int8 codes). Rows and
queries are unit vectors from a seed, codes and scales from
``quantize_int8``. Each time is a CUDA-event median of 5 after a warm-up;
each process also prints a checksum of its outputs, which must agree
across copies where the kernels compute the same words (K3's always: its
sums are exact). Prints one JSON line a process, then nvidia-smi's name and
power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPS = 5


def run_one(pkg_dir: str) -> dict:
    """Time the scans of the package in ``pkg_dir`` (in this process)."""
    sys.path.insert(0, os.path.abspath(pkg_dir))
    import torch
    from optimized_rag_tpu_torch.ops import _build
    from optimized_rag_tpu_torch.ops import topk_kernels as K
    from optimized_rag_tpu_torch.ops.quantize import quantize_int8
    where = os.path.abspath(K.__file__)
    if not where.startswith(os.path.abspath(pkg_dir) + os.sep):
        raise RuntimeError(f"imported {where}, not from {pkg_dir}")
    _build.load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)

    def unit(*shape):
        return torch.nn.functional.normalize(
            torch.randn(*shape, generator=gen, device=dev), dim=1)

    def codes(rows, block=1 << 20):
        """int8 codes and row scales of ``rows``, quantized in blocks."""
        c8 = torch.empty(rows.shape, dtype=torch.int8, device=dev)
        cs = torch.empty(rows.shape[0], device=dev)
        for lo in range(0, rows.shape[0], block):
            c8[lo:lo + block], cs[lo:lo + block] = quantize_int8(
                rows[lo:lo + block].float())
        return c8, cs
    bench = unit(10_485_760, 128).to(torch.bfloat16)
    q = unit(1024, 128)
    served = unit(4_194_304, 384).to(torch.bfloat16)
    qs = unit(64, 384)
    bench8, bench_cs = codes(bench)
    q8, q8_scale = quantize_int8(q)
    served8 = torch.empty((16_777_216, 384), dtype=torch.int8, device=dev)
    served_cs = torch.empty(16_777_216, device=dev)
    for lo in range(0, 16_777_216, 1 << 22):
        served8[lo:lo + (1 << 22)], served_cs[lo:lo + (1 << 22)] = codes(
            unit(1 << 22, 384))
    qs8, qs8_scale = quantize_int8(qs)
    cases = {
        "K1 bf16 B=1024 tile 4096": lambda: K.packed_extract(q, bench, None,
                                                             4096, 8),
        "K1 bf16 B=512 tile 4096": lambda: K.packed_extract(q[:512], bench,
                                                            None, 4096, 8),
        "F bf16 B=1024 tile 4096": lambda: K.scan_floor(q, bench, 4096),
        "K1 bf16 served B=64 tile 1024": lambda: K.packed_extract(
            qs, served, None, 1024, 8),
        "K2 int8 B=1024 tile 4096": lambda: K.packed_extract_scaled(
            q, bench8, bench_cs, None, 4096, 8),
        "K3 int8 B=1024 tile 4096": lambda: K.packed_extract_int8(
            q8, q8_scale, bench8, bench_cs, None, 4096, 8),
        "K3 int8 served B=64 tile 1024": lambda: K.packed_extract_int8(
            qs8, qs8_scale, served8, served_cs, None, 1024, 8)}
    out = {"dir": pkg_dir, "library": _build.build_info["library"]}
    for name, fn in cases.items():
        ref = fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = {"ms": sorted(times)[REPS // 2],
                     "checksum": int(ref.double().sum().item() * 1e3)}
    return out


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(run_one(sys.argv[2])), flush=True)
        return
    dirs = sys.argv[1:]
    if not dirs:
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("scan_ab needs a CUDA card; none is visible")
    for d in dirs:                      # build each copy first, untimed
        subprocess.run([sys.executable, "-c", (
            "import sys; sys.path.insert(0, sys.argv[1]); "
            "from optimized_rag_tpu_torch.ops import _build; "
            "_build.load_library()"), os.path.abspath(d)], check=True)
    for d in dirs + dirs[::-1]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        d], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
