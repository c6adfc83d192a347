"""mfu.batch: the window's work at the published peak over its length,
in %: each query's scores against every live row at the storage dtype's
peak."""

from portbench import readers


def read(run):
    d = run.load
    if not d.calls:
        return None
    queries = len(d.calls) * d.pool.shape[1]
    return 100.0 * readers.topk_time_at_peak(run, queries) / (d.t1 - d.t0)
