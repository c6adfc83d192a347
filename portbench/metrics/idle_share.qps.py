"""idle_share.qps: share of the window with no kernel, copy or fill on
the device, from the raw trace, in %."""

from portbench import readers


def read(run):
    return readers.idle_share(run)
