"""mfu.qps: the window's work at the published peaks over its length, in
%: for each request answered in it, the encoder's matmul and attention
operations over its real tokens at the encoder dtype's peak, plus its
scores against every live row at the storage dtype's peak."""

from portbench import readers


def read(run):
    done = [r.text for r in run.load.requests
            if r.error is None and r.ids is not None
            and readers.in_window(run, r.t_done)]
    if not done:
        return None
    at_peak = (readers.encoder_time_at_peak(run, done)
               + readers.topk_time_at_peak(run, len(done)))
    return 100.0 * at_peak / readers.window_s(run)
