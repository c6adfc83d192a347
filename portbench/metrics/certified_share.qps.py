"""certified_share.qps: share of the window's DenseIndex.search calls
whose route is "certified" (no fallback rerun), in %."""

from portbench import readers


def read(run):
    return readers.route_share(run, "certified")
