"""On a card: one short run of the batch cell through ``run.py``, whose
result line must say ``correct``. Run on the card with
``python -m pytest -p no:cacheprovider portbench/tests -m cuda``."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_batch_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         "mrl128.bf16-10m.batch-b4096", "--seed", str(2 ** 31 + 7),
         "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
