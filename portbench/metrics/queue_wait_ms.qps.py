"""queue_wait_ms.qps: mean wait of a request in QueryServer's queue, from
its enqueue to the start of its batch's dispatch, over the batches that
start in the window (the program's serve.dispatch spans), in ms."""

from portbench import program_spans


def read(run):
    d = [r for r, _ in program_spans.calls(run, "serve.dispatch")]
    n = sum(r.attrs["n"] for r in d)
    return sum(r.attrs["wait_ms_sum"] for r in d) / n if n else None
