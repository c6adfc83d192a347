"""The device trace of a ``--trace 1`` run, read from memory.

``torch.profiler`` records CPU and CUDA activity from before the load
starts until it ends; the window is the ``portbench.window`` range that the
harness opens and closes, at a perf_counter time it notes, which ties the
trace's clock to the wrappers' host spans (``spans.py``). The device's
events (kernels, copies, fills) are read from the raw kineto events, as
``device_busy`` does (``chip_smoke.py:1950-1972``, commit 6ca9d44):
building the profiler's event tree would cost the host seconds. Nothing is
written to disk.

The top-k's own kernels are the program's hand-written ones (``csrc/``,
in namespace ``orag``); nothing else launches them. (Their launches,
made through the kernels' library by the server's worker threads, reach
the trace under another thread than the worker's, so device time is not
attributed to the wrapped calls by thread.)
"""

from __future__ import annotations

from collections import Counter

import torch

from portbench.spans import layers

_WINDOW = "portbench.window"
TOPK_KERNELS = "orag::"


class Trace:
    def __init__(self):
        self._prof = None
        self._window = None
        self._t_open = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        # The tracer can miss the first kernels after it starts.
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    def open_window(self, t_perf: float) -> None:
        from torch.profiler import record_function
        self._t_open = t_perf
        self._window = record_function(_WINDOW)
        self._window.__enter__()

    def close_window(self) -> None:
        self._window.__exit__(None, None, None)

    def stop(self, spans) -> dict:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        summary = reduce(self._prof.profiler.kineto_results.events(),
                         spans, self._t_open)
        self._prof = None
        return summary


def _union(intervals) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce(events, spans, t_open: float) -> dict:
    """The window's device busy time, its device time by operation name
    and of the top-k's kernels, and its idle gaps by what the host was
    doing (ns): the layer of every span ``spans`` holds."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = []
    w0 = w1 = None
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if not name.startswith("portbench"):
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            name))
        elif name == _WINDOW:
            w0, w1 = e.start_ns(), e.start_ns() + e.duration_ns()
    if w0 is None:
        raise RuntimeError("the trace holds no window range")
    inside = [(max(s, w0), min(t, w1), n) for s, t, n in dev
              if t > w0 and s < w1]
    by_name = Counter()
    for s, t, n in inside:
        by_name[n] += t - s
    host = sorted((w0 + (sp[0] - t_open) * 1e9, w0 + (sp[1] - t_open) * 1e9,
                   layer) for layer, held in layers(spans).items()
                  for sp in held)
    return {"window_ns": w1 - w0,
            "busy_ns": _union((s, t) for s, t, _ in inside),
            "by_name_ns": by_name,
            "topk_kernel_ns": sum(v for n, v in by_name.items()
                                  if TOPK_KERNELS in n),
            "idle_gaps_ns": _gaps(inside, host, w0, w1)}


def _gaps(inside, host, w0, w1) -> Counter:
    """Idle time between the window's device events, by the wrapped call
    in flight at the middle of each gap (on any thread; the earliest
    started), else "no call in flight"."""
    gaps, active, j, prev = Counter(), [], 0, w0
    edges = sorted((s, t) for s, t, _ in inside) + [(w1, w1)]
    for s, t in edges:
        if s > prev:
            mid = (prev + s) / 2
            while j < len(host) and host[j][0] <= mid:
                active.append(host[j])
                j += 1
            active = [h for h in active if h[1] >= mid]
            gaps[active[0][2] if active else "no call in flight"] += s - prev
        prev = max(prev, t)
    return gaps
