"""The control: the plain reference put in the program's place, one step
below the precision the configuration states, judged by the same check.

    python3 portbench/control.py --workload <name> --seeds 1 2 3

The configuration's kind of system (``systems/<kind>.py``) computes the
control's answers, to what a run of the cell would ask first, at the
cell's sizes, and judges them as it judges the program's. Prints the
numbers the check compares, one JSON line a seed. The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT

from portbench import check, harness  # noqa: E402


def run(c, seed: int, device, n_answers: int) -> dict:
    kind = harness.kind(c.cfg)
    inputs, ans = kind.control_answers(c, seed, device, n_answers)
    numbers = kind.compare(c.cfg, inputs, ans, seed, device)
    return {"workload": c.name, "seed": seed, "numbers": numbers,
            "correct": check.verdict(numbers, c.limits)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--answers", type=int, default=16384)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    c = harness.cell(harness.benchmark(), a.workload)
    for seed in a.seeds:
        print(json.dumps(run(c, seed, a.device, a.answers)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
