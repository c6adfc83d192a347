"""fallback_ms.batch: host ms of search.fallback (the exact rerun after a
nonzero certificate, and its copy to the host) summed over the window's
DenseIndex.search calls, over their number (the program's spans)."""

from portbench import program_spans


def read(run):
    return program_spans.child_ms(run, "search", "search.fallback")
