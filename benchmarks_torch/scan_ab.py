#!/usr/bin/env python3
"""Time K1 and F over bf16 rows from two or more copies of the package.

    python3 benchmarks_torch/scan_ab.py DIR [DIR ...]   # needs one CUDA card

Each DIR holds an ``optimized_rag_tpu_torch`` package (the repository
root, or an earlier commit unpacked with ``git archive``); its kernels
build into DIR's own ``build/``. Every copy is timed in a process of its
own, in turns (A, B, B, A), at the shapes the paths give the scans: the
reference benchmark's (10,485,760 x 128 bf16 rows, tile 4096, groups 8;
K1 at B=1024 and 512, F at 1024) and the served one (4,194,304 x 384 bf16
rows, tile 1024, K1 at B=64). Rows and queries are unit vectors from a
seed. Each time is a CUDA-event median of 5 after a warm-up; each process
also prints a checksum of its outputs, which must agree across copies
where the kernels compute the same words. Prints one JSON line a process,
then nvidia-smi's name and power limit.
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
    where = os.path.abspath(K.__file__)
    if not where.startswith(os.path.abspath(pkg_dir) + os.sep):
        raise RuntimeError(f"imported {where}, not from {pkg_dir}")
    _build.load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)

    def unit(*shape):
        return torch.nn.functional.normalize(
            torch.randn(*shape, generator=gen, device=dev), dim=1)
    bench = unit(10_485_760, 128).to(torch.bfloat16)
    q = unit(1024, 128)
    served = unit(4_194_304, 384).to(torch.bfloat16)
    qs = unit(64, 384)
    cases = {
        "K1 bf16 B=1024 tile 4096": lambda: K.packed_extract(q, bench, None,
                                                             4096, 8),
        "K1 bf16 B=512 tile 4096": lambda: K.packed_extract(q[:512], bench,
                                                            None, 4096, 8),
        "F bf16 B=1024 tile 4096": lambda: K.scan_floor(q, bench, 4096),
        "K1 bf16 served B=64 tile 1024": lambda: K.packed_extract(
            qs, served, None, 1024, 8)}
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
