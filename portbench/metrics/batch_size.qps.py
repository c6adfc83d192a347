"""batch_size.qps: queries per batch the QueryServer dispatched over
the window (its own counters, get_stats())."""

from portbench import readers


def read(run):
    d = readers.stats_delta(run)
    return d["queries"] / d["batches"] if d else None
