"""rerun_share.qps: share of the window's DenseIndex.search calls with a
nonzero certificate that reran the whole tiled search (K6) instead of
repairing the (query, tile) pairs the covers left, in % (the ``rerun``
attribute of their search.fallback spans; the program's spans). None
where no search.fallback carries it, as in a program without the repair."""

from portbench import program_spans


def read(run):
    reruns = [k.attrs["rerun"]
              for _, kids in program_spans.calls(run, "search")
              for k in kids
              if k.name == "search.fallback" and "rerun" in k.attrs]
    return 100.0 * sum(reruns) / len(reruns) if reruns else None
