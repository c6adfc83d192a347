"""The portbench tests' settings: the ``cuda`` marker, and the repository
root on ``sys.path``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


import pytest  # noqa: E402


def shrink(c):
    """A cell cut to a size the CPU runs in seconds: 65,536 rows in tiles
    of 128, 8 clients or batches of 64."""
    c.cfg["corpus"].update(rows=65536, clusters=64,
                           runs=8 if c.cfg["corpus"]["runs"] else 0)
    c.cfg["index"].update(tile=128, capacity_block=16384)
    if c.mix["generator"] == "batch":
        c.mix.update(batch=64, pool=2)
    else:
        c.mix.update(clients=8, warmup_s=0.3)
        if c.mix["loop"] == "open":
            c.mix["rate_qps"] = 40.0
    return c


@pytest.fixture
def tiny_cell():
    """``tiny_cell(workload)``: the workload of BENCHMARK.json, shrunk."""
    import torch

    from portbench import harness
    torch.set_num_threads(4)

    def make(name):
        return shrink(harness.cell(harness.benchmark(), name))
    return make
