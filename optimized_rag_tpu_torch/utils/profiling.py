"""Tracing and profiling.

Held against ``optimized_rag_tpu/utils/profiling.py``:

  * ``StageTimer`` — nested wall-clock spans on the host clock, each
    thread with a stack of its own; queryable stats by path
    (count/total/mean/p50/p95). With a ``capacity`` it also keeps its last
    ``capacity`` spans as ``Span`` records (name, ids, times, the thread's
    CPU time, attributes), which ``records`` selects by start time.
  * ``RECORDER`` and ``span`` — the process-wide recorder of the program's
    own spans (the serving queue, the encoder, the dense index). It records
    only while a torch profiler session is active (``device_trace``, or any
    ``torch.profiler.profile``); otherwise ``span`` returns a shared no-op
    context that reads no clock, allocates nothing and takes no lock. No
    span opens a ``record_function`` range or touches the device: with CUDA
    activity on, every such range also comes back as a device-side event.
  * ``device_trace`` — context manager around ``torch.profiler`` (CPU and,
    where a card is visible, CUDA activity) that writes a Chrome trace into
    ``log_dir``, where the reference wraps ``jax.profiler``; the recorder's
    spans of the session go into the same trace, on its clock
  * ``annotate`` — ``torch.profiler.record_function``, so engine stages
    are named inside the trace
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# Spans the process-wide recorder keeps: a 10-s window of the served path
# opens about 4,000.
RECORDER_CAPACITY = 1 << 16
_ANCHOR = "orag.clock_anchor"


class Span:
    """One span of a ``StageTimer``; a context manager that opens it.

    ``start_ns`` and ``end_ns`` are on ``time.perf_counter``'s clock, in ns;
    ``parent`` is the ``id`` of the span open on the same thread when this
    one opened (None at the top, and for a detached span); ``cpu_ns`` is the
    thread's CPU time over the span (None for a detached span, which may end
    on another thread); ``thread`` is the native id of the thread that
    opened it; ``attrs`` holds what the caller noted."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "cpu_ns",
                 "thread", "attrs", "_timer", "_path", "_t0", "_cpu0")

    def __init__(self, timer: "StageTimer", name: str):
        self._timer = timer
        self.name = name
        self.attrs = {}

    def _open(self, parent: "Span | None", on_thread: bool) -> None:
        timer = self._timer
        self._path = parent._path + "/" + self.name if parent else self.name
        if timer._records is not None:
            self.id = next(timer._ids)
            self.parent = parent.id if parent else None
            if on_thread:
                self.thread = timer._local.thread
                self._cpu0 = time.thread_time_ns()
            else:
                self.thread = threading.get_native_id()
                self._cpu0 = None
        self._t0 = time.perf_counter()

    def finish(self) -> None:
        """Closes the span (a detached one from any thread)."""
        t1 = time.perf_counter()
        timer = self._timer
        timer._spans[self._path].append(t1 - self._t0)
        if timer._records is not None:
            self.cpu_ns = (None if self._cpu0 is None
                           else time.thread_time_ns() - self._cpu0)
            self.start_ns = round(self._t0 * 1e9)
            self.end_ns = round(t1 * 1e9)
            timer._records.append(self)

    def __enter__(self) -> "Span":
        stack = self._timer._stack()
        self._open(stack[-1] if stack else None, True)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._timer._stack().pop()
        self.finish()
        return False


class _Off:
    """The span ``span`` returns while nothing records: it does nothing
    and is false, so callers skip work that only feeds attributes."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def finish(self) -> None:
        pass


OFF = _Off()


class StageTimer:
    """Nested spans with stats by path; with ``capacity``, the last
    ``capacity`` spans kept as records. Safe to use from many threads."""

    def __init__(self, capacity: int = 0):
        self._spans: Dict[str, List[float]] = defaultdict(list)
        self._local = threading.local()
        self._records = (collections.deque(maxlen=capacity) if capacity
                         else None)
        self._ids = itertools.count()

    def _stack(self) -> List[Span]:
        """This thread's open spans (its native id kept beside them: the
        call is a system call)."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.thread = threading.get_native_id()
            self._local.stack = []
            return self._local.stack

    def span(self, name: str) -> Span:
        """``with timer.span(name) as sp:`` times the block; its path is
        the names of the spans open on this thread, joined by "/"."""
        return Span(self, name)

    def detached(self, name: str) -> Span:
        """A span opened now, outside this thread's stack, that
        ``finish()`` closes, on any thread."""
        sp = Span(self, name)
        sp._open(None, False)
        return sp

    def records(self, t0: float, t1: float = math.inf) -> List[Span]:
        """The kept spans that start in ``[t0, t1)`` (perf_counter
        seconds)."""
        if self._records is None:
            return []
        lo, hi = t0 * 1e9, t1 * 1e9
        return [r for r in list(self._records) if lo <= r.start_ns < hi]

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, times in list(self._spans.items()):
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
        if self._records is not None:
            self._records.clear()


RECORDER = StageTimer(RECORDER_CAPACITY)


def span(name: str):
    """``with span(name) as sp:`` records a span of ``RECORDER`` while a
    profiler session is active, else does nothing; ``sp`` is false when
    nothing records, so ``if sp: sp.attrs[...] = ...``. Whether a session
    is active is read from the flag torch keeps for its own cheap checks."""
    if _autograd_profiler._is_profiler_enabled:
        return RECORDER.span(name)
    return OFF


def detached(name: str):
    """``RECORDER.detached(name)`` while a profiler session is active, else
    the no-op span."""
    if _autograd_profiler._is_profiler_enabled:
        return RECORDER.detached(name)
    return OFF


def _anchor() -> int:
    """A perf_counter_ns reading and, right after it, a range of its own in
    the profiler's trace: two of them map one clock onto the other."""
    t = time.perf_counter_ns()
    with record_function(_ANCHOR):
        pass
    return t


def _write_spans(path: str, t_first: int, t_last: int) -> None:
    """Adds the recorder's spans that start between the two anchors to the
    Chrome trace at ``path``, as complete events on their threads, on the
    trace's clock (us)."""
    spans = RECORDER.records(t_first / 1e9, t_last / 1e9)
    if not spans:
        return
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    a, b = (e for e in events if e.get("name") == _ANCHOR
            and e.get("cat") == "user_annotation")
    rate = (b["ts"] - a["ts"]) / (t_last - t_first)   # us per ns

    def us(ns):
        return a["ts"] + (ns - t_first) * rate

    for r in spans:
        events.append({
            "ph": "X", "cat": "orag_span", "name": r.name, "pid": a["pid"],
            "tid": r.thread, "ts": us(r.start_ns),
            "dur": (r.end_ns - r.start_ns) * rate,
            "args": {"id": r.id, "parent": r.parent, "cpu_ns": r.cpu_ns,
                     **r.attrs}})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """``torch.profiler`` trace of the enclosed work, written as
    ``log_dir/trace.json`` (Chrome trace format; open in Perfetto or
    chrome://tracing; ``log_dir`` defaults to ``orag_trace`` in the
    temporary directory), with the program's spans of the session (``span``)
    as events of category ``orag_span`` on their threads. Records CUDA
    activity whenever a card is visible, and yields the profiler, whose
    ``key_averages()`` sums time by operator and kernel."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "orag_trace")
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if cuda:
            # The tracer can miss the first kernels after it starts (a smoke
            # run's trace lost 2 of 16): one synchronised kernel first.
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        t_first = _anchor()
        yield prof
        if cuda:
            torch.cuda.synchronize()
        t_last = _anchor()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path, t_first, t_last)


def annotate(name: str):
    """Named region visible in the device trace timeline."""
    return record_function(name)
