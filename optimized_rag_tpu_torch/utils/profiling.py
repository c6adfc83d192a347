"""Tracing and profiling.

Held against ``optimized_rag_tpu/utils/profiling.py``:

  * ``StageTimer`` — nested per-stage wall-clock spans on the host clock,
    queryable stats (count/total/mean/p50/p95), exportable to the JSONL
    metrics stream (a copy of the reference's)
  * ``device_trace`` — context manager around ``torch.profiler`` (CPU and,
    where a card is visible, CUDA activity) that writes a Chrome trace into
    ``log_dir``, where the reference wraps ``jax.profiler``
  * ``annotate`` — ``torch.profiler.record_function``, so engine stages
    are named inside the trace
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function


class StageTimer:
    def __init__(self):
        self._spans: Dict[str, List[float]] = defaultdict(list)
        self._stack: List[tuple] = []

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        path = ("/".join(s for s, _ in self._stack) + "/" + name).lstrip("/")
        self._stack.append((name, time.perf_counter()))
        try:
            yield
        finally:
            _, t0 = self._stack.pop()
            self._spans[path].append(time.perf_counter() - t0)

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, times in self._spans.items():
            arr = np.asarray(times)
            out[name] = {
                "count": len(arr),
                "total_s": float(arr.sum()),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
            }
        return out

    def reset(self) -> None:
        self._spans.clear()

    def export(self, exporter) -> None:
        """Write stats through a utils.metrics_export.MetricsExporter."""
        exporter.export({"kind": "stage_timings", "stages": self.stats()})


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """``torch.profiler`` trace of the enclosed work, written as
    ``log_dir/trace.json`` (Chrome trace format; open in Perfetto or
    chrome://tracing; ``log_dir`` defaults to ``orag_trace`` in the
    temporary directory). Records CUDA activity whenever a card is visible,
    and yields the profiler, whose ``key_averages()`` sums time by
    operator and kernel."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "orag_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region visible in the device trace timeline."""
    return record_function(name)


GLOBAL_TIMER = StageTimer()
