"""search_wait_ms.batch: mean host ms of search.wait per DenseIndex.search
call that starts in the window (the program's spans): the candidates' copy
to the host, which waits for the scan's kernels."""

from portbench import program_spans


def read(run):
    return program_spans.child_ms(run, "search", "search.wait")
