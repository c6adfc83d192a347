"""The trace reduction on hand-made kineto events: the window, the busy
union, the top-k's kernels by name, idle gaps by the call in flight; and
the readers that use it."""

from types import SimpleNamespace

import pytest
import torch

from portbench import readers
from portbench.trace import reduce

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
W0 = 1_000_000_000


class Event:
    def __init__(self, name, device, start, duration):
        self._v = (name, device, start, duration)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


EVENTS = [
    Event("portbench.window", CPU, W0, 100_000_000),
    Event("void orag::packed_extract_kernel<f>", CUDA, W0 - 1_000_000,
          3_000_000),                       # 2 ms of it in the window
    Event("void orag::stream_topk_kernel<f>", CUDA, W0 + 11_000_000,
          5_000_000),
    Event("void orag::stream_topk_kernel<f>", CUDA, W0 + 13_000_000,
          4_000_000),                       # overlaps: busy is a union
    Event("nvjet_gemm", CUDA, W0 + 31_000_000, 2_000_000),
    Event("nvjet_gemm", CUDA, W0 + 99_000_000, 5_000_000),   # 1 ms in
]
# Host spans on perf_counter; the window opened at t = 5.0 s.
SPANS = SimpleNamespace(search=[(5.005, 5.020, 64, 16, "fallback")],
                        encode=[(5.025, 5.040, [], None)])


def test_reduce_counts_the_window_only():
    r = reduce(EVENTS, SPANS, 5.0)
    assert r["window_ns"] == 100_000_000
    assert r["busy_ns"] == 2_000_000 + 6_000_000 + 2_000_000 + 1_000_000
    assert r["topk_kernel_ns"] == 2_000_000 + 5_000_000 + 4_000_000
    gaps = r["idle_gaps_ns"]
    assert sum(gaps.values()) == r["window_ns"] - r["busy_ns"]
    assert gaps["search"] == 9_000_000          # 2 .. 11 ms, mid in search
    assert gaps["no call in flight"] == 14_000_000 + 66_000_000


def test_reduce_needs_the_window():
    with pytest.raises(RuntimeError):
        reduce(EVENTS[1:], SPANS, 5.0)


def test_readers_on_the_reduced_trace():
    trace = reduce(EVENTS, SPANS, 5.0)
    cell = SimpleNamespace(cfg={"index": {"dim": 384, "dtype": "float32"}})
    run = SimpleNamespace(trace=trace, spans=SPANS, t0=5.0, t1=5.1,
                          n_rows=4_194_304, cell=cell)
    assert readers.idle_share(run) == pytest.approx(89.0)
    # One call of 64 real queries: 3.077 ms at least, 11 ms of kernels.
    assert readers.topk_roofline(run) == pytest.approx(
        100 * 3.0772 / 11.0, rel=1e-4)
    assert readers.route_share(run, "certified") == 0.0
    assert readers.mean_ms(run, "search") == pytest.approx(15.0)
    assert readers.percentile([5, 1, 4, 2, 3], 95) == 5
    assert readers.percentile(list(range(1, 101)), 95) == 95
