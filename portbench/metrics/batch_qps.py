"""batch_qps: queries answered by the window's back-to-back batch calls,
per second from the first call's start to the last one's end."""


def read(run):
    d = run.load
    if not d.calls:
        return None
    return len(d.calls) * d.pool.shape[1] / (d.t1 - d.t0)
