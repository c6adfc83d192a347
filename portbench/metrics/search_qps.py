"""search_qps: /search requests answered in the window, per second of it."""

from portbench import readers


def read(run):
    done = [r for r in run.load.requests
            if r.error is None and r.ids is not None
            and readers.in_window(run, r.t_done)]
    return len(done) / readers.window_s(run)
