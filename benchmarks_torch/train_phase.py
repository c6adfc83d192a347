#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training phase alone: its device and build
phases, then ``slice_train`` (the four trainers at the checkpoints' widths,
their CPU replays, a float16 checkpoint, a resumed step and ``train`` from
the CLI; see ``chip_smoke.phase_slice_train``).

    python3 benchmarks_torch/train_phase.py      # needs one CUDA card

Prints the phases' JSON lines, then nvidia-smi's name and power limit and
the seconds the run took. Work files go to a temporary directory under
``build/``, removed at the end.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("train_phase needs a CUDA card; none is visible")
    import optimized_rag_tpu_torch  # noqa: F401  (turns TF32 off)
    from optimized_rag_tpu_torch.ops import topk as T_
    from optimized_rag_tpu_torch.ops import topk_kernels as K_
    S.start_watchdog()
    _, smi = S.phase_device()
    S.phase_build()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="slice_train-",
                            dir=os.path.join(HERE, "build"))
    try:
        S.phase_slice_train(K_, T_, torch.device("cuda", 0), S.qa_chunks(),
                            work, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(smi, flush=True)
    print(f"seconds {time.perf_counter() - S._T0:.1f}", flush=True)


if __name__ == "__main__":
    main()
