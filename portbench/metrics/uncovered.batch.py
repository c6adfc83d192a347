"""uncovered.batch: mean count of (query, tile) pairs the certificate left
uncovered, over the window's DenseIndex.search calls that took the
certified scan (route certified or fallback; the program's search spans).
0 proves a call exact; above 0 it reruns the exact search."""

from portbench import program_spans


def read(run):
    return program_spans.mean_uncovered(run)
