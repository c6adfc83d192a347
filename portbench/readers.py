"""What the metric readers under ``metrics/`` share: the window's spans,
requests and calls, and its work at the chip's peaks."""

from __future__ import annotations

import math

from portbench import work


def window_s(run) -> float:
    return run.t1 - run.t0


def in_window(run, t: float) -> bool:
    return run.t0 <= t < run.t1


def spans(run, layer: str) -> list[tuple]:
    """The ``layer`` ("encode" or "search") spans that start in the
    window."""
    return [s for s in getattr(run.spans, layer) if in_window(run, s[0])]


def mean_ms(run, layer: str):
    s = spans(run, layer)
    return 1e3 * sum(t1 - t0 for t0, t1, *_ in s) / len(s) if s else None


def route_share(run, route: str):
    s = spans(run, "search")
    return 100.0 * sum(1 for x in s if x[4] == route) / len(s) if s else None


def stats_delta(run):
    """The server's counters over the window, or None."""
    a, b = run.marks.get("stats0"), run.marks.get("stats1")
    if a is None or b is None or b["batches"] == a["batches"]:
        return None
    return {key: b[key] - a[key] for key in ("batches", "queries",
                                             "wait_ms_sum")}


def percentile(values: list[float], q: float) -> float:
    """Nearest rank: the smallest value with at least q% at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def topk_roofline(run):
    """The least time of the window's searches over the device time of
    the top-k's kernels in the window, in %."""
    if run.trace is None:
        return None
    device_ns = run.trace["topk_kernel_ns"]
    s = spans(run, "search")
    if not device_ns or not s:
        return None
    ix = run.cell.cfg["index"]
    least = sum(work.topk_bound_ms(b, run.n_rows, int(ix["dim"]), k,
                                   ix["dtype"]) for _, _, b, k, _ in s)
    return 100.0 * least * 1e6 / device_ns


def idle_share(run):
    if run.trace is None or not run.trace["window_ns"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_ns"] / run.trace["window_ns"])


def topk_time_at_peak(run, queries: int) -> float:
    ix = run.cell.cfg["index"]
    return queries * work.topk_flops(1, run.n_rows, int(ix["dim"])) \
        / work.PEAK[ix["dtype"]]


def encoder_time_at_peak(run, texts: list[str]) -> float:
    from portbench.system import tokenizer
    cfg = run.cell.cfg
    enc = cfg["encoder"]
    tok = tokenizer(cfg)
    flops = sum(work.encoder_flops(
        tok.real_tokens(t, int(enc["max_len"])),
        int(cfg["num_hidden_layers"]), int(cfg["hidden_size"]),
        int(cfg["intermediate_size"]), int(enc["projection"]))
        for t in texts)
    return flops / work.PEAK[enc["dtype"]]
