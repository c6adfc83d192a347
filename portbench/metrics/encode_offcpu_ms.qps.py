"""encode_offcpu_ms.qps: mean of (wall time - the thread's CPU time) over the
EmbeddingService.encode calls that start in the window (the program's
spans), in ms: time the calling thread spent off the CPU, waiting for the
interpreter lock, a lock or a blocking call."""

from portbench import program_spans


def read(run):
    c = [r for r, _ in program_spans.calls(run, "encode")]
    if not c:
        return None
    return sum(program_spans.ms(r) - r.cpu_ns / 1e6 for r in c) / len(c)
