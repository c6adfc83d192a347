#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s eval and tensor-parallel phases alone: its device
and build phases, then ``slice_eval`` (the KG eval, the QA sheets and
``--local-lm`` with their CPU replays, the encoder gauntlet; see
``chip_smoke.phase_slice_eval``) and ``slice_tp`` (tensor-parallel training
on one card; ``chip_smoke.phase_slice_tp``).

    python3 benchmarks_torch/eval_phase.py           # both; needs one card
    python3 benchmarks_torch/eval_phase.py eval      # slice_eval alone
    python3 benchmarks_torch/eval_phase.py tp        # slice_tp alone

Prints the phases' JSON lines, then the kernel entries of slice_eval's
paths, nvidia-smi's name and power limit and the seconds the run took.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("eval_phase needs a CUDA card; none is visible")
    import optimized_rag_tpu_torch  # noqa: F401  (turns TF32 off)
    from optimized_rag_tpu_torch.ops import topk as T_
    from optimized_rag_tpu_torch.ops import topk_kernels as K_
    which = argv or ["eval", "tp"]
    S.start_watchdog()
    _, smi = S.phase_device()
    S.phase_build()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    dev = torch.device("cuda", 0)
    if "eval" in which:
        held = S.phase_slice_eval(K_, T_, dev, smi)
        print(json.dumps({"kernels": [S.kernel_entry(
            rec["name"],
            f"{rec['dtype']} slice_eval N={rec['N']} {rec['shape']}",
            rec["launches_by_path"], rec) for rec in held]}), flush=True)
    if "tp" in which:
        S.phase_slice_tp(dev, S.qa_chunks(), smi)
    print(smi, flush=True)
    print(f"seconds {time.perf_counter() - S._T0:.1f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
