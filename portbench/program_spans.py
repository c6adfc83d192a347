"""The program's own spans, as the metric readers under ``metrics/`` read
them: the records of ``optimized_rag_tpu_torch.utils.profiling.RECORDER``,
which records while a profiler session is on (a ``--trace 1`` run). Each
record has ``name``, ``id``, ``parent`` (the id of the span that encloses
it on its thread), ``start_ns`` and ``end_ns`` on ``time.perf_counter``'s
clock, ``cpu_ns`` (the thread's CPU time over it) and ``attrs``. A program
without the recorder gives no records, and every reader then returns
None."""

from __future__ import annotations

import math


def records(run) -> list:
    """The program's spans that start at or after the window's start."""
    from optimized_rag_tpu_torch.utils import profiling
    recorder = getattr(profiling, "RECORDER", None)
    if recorder is None:
        return []
    return recorder.records(run.t0, math.inf)


def calls(run, name: str) -> list[tuple]:
    """(span, its child spans) for each ``name`` span that starts in the
    window."""
    recs = records(run)
    t1_ns = run.t1 * 1e9
    kids = {r.id: (r, []) for r in recs
            if r.name == name and r.start_ns < t1_ns}
    for r in recs:
        if r.parent in kids:
            kids[r.parent][1].append(r)
    return list(kids.values())


def ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def child_ms(run, name: str, child: str):
    """Mean ms of ``child`` spans per ``name`` span of the window (a call
    without one counts 0), or None without ``name`` spans."""
    c = calls(run, name)
    if not c:
        return None
    return sum(ms(k) for _, ks in c for k in ks if k.name == child) / len(c)


def mean_uncovered(run):
    """Mean uncovered count of the certificate over the window's searches
    that had one (route certified or fallback), or None."""
    u = [r.attrs["uncovered"] for r, _ in calls(run, "search")
         if r.attrs.get("route") in ("certified", "fallback")]
    return sum(u) / len(u) if u else None
