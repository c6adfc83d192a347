#!/usr/bin/env python3
"""Time the FMA packed scan (K1 over f32 rows) under its two register
policies (K1 over bf16/f16 rows, K2 over int8 codes and bf16 rows, and K3
run csrc/scan_mma.cuh instead; K2 over f16 and f32 rows, which keeps the
FMA kernel, has no search path at a measured shape).

    python3 benchmarks_torch/packed_min_blocks.py      # needs one CUDA card

``csrc/packed_extract.cu`` asks ptxas to fit three blocks an SM
(``__launch_bounds__(256, 3)``, at most 85 registers a thread) where three
blocks' shared memory fits an SM, and one block (no cap) elsewhere. This
script builds the kernels three times, as shipped and with the policy
forced to 3 and to 1 at every tile (``-DORAG_PACKED_MIN_BLOCKS``), and
times the scan at the shape its path gives it: tile 1024 at the served
shape (B=64, D=384, 4,194,304 f32 rows). The builds' order alternates (as
shipped, 3, 1, 1, 3, as shipped) and each time is a CUDA-event median.
Prints one JSON line, then ptxas's registers per variant, then
nvidia-smi's name and power limit.
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

VARIANTS = {"as_shipped": [], "min_blocks_3": ["-DORAG_PACKED_MIN_BLOCKS=3"],
            "min_blocks_1": ["-DORAG_PACKED_MIN_BLOCKS=1"]}
ORDER = ("as_shipped", "min_blocks_3", "min_blocks_1", "min_blocks_1",
         "min_blocks_3", "as_shipped")
REPS = 5


def build(flags):
    """The kernels' library built with extra nvcc ``flags``; returns it and
    ptxas's register lines for the packed scans."""
    from optimized_rag_tpu_torch.ops import _build
    saved = list(_build.COMPILE_FLAGS), _build.BUILD_DIR
    _build.COMPILE_FLAGS = saved[0] + flags
    _build.BUILD_DIR = os.path.join(HERE, "build", "min_blocks")
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
            entry = ("packed_extract_kernel" in line
                     and line.split("'")[1])
        elif entry and "Used" in line:
            regs.append(f"{entry}: {line.split(':', 1)[1].strip()}")
    return lib, regs


def median_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def unit_rows(n, d, gen, dev, dtype):
    out = torch.empty((n, d), dtype=dtype, device=dev)
    for lo in range(0, n, 1 << 20):
        x = torch.randn(min(n - lo, 1 << 20), d, generator=gen, device=dev)
        out[lo:lo + x.shape[0]] = (x / x.norm(dim=1, keepdim=True)).to(dtype)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("packed_min_blocks needs a CUDA card")
    import optimized_rag_tpu_torch  # noqa: F401  (turns TF32 off)
    from optimized_rag_tpu_torch.ops import _build
    from optimized_rag_tpu_torch.ops import topk_kernels as K_
    dev = torch.device("cuda", 0)
    libs = {name: build(flags) for name, flags in VARIANTS.items()}
    gen = torch.Generator(device=dev).manual_seed(7)
    n, d, b, tile = 4_194_304, 384, 64, 1024
    q = unit_rows(b, d, gen, dev, torch.float32)
    rows = unit_rows(n, d, gen, dev, torch.float32)
    times = {name: [] for name in VARIANTS}
    for name in ORDER:
        _build._lib = libs[name][0]
        times[name].append(median_ms(
            lambda: K_.packed_extract(q, rows, None, tile, 8)))
    _build._lib = None
    print(json.dumps({"kernel": "K1 f32", "tile": tile, "ms": times,
                      "mean_ms": {k: sum(v) / len(v)
                                  for k, v in times.items()}}), flush=True)
    print(json.dumps({"ptxas_registers": {k: v[1] for k, v in libs.items()}}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
