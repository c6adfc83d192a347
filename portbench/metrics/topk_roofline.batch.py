"""topk_roofline.batch: the least time of the window's searches (rows read
once against 2 B N D at the storage dtype's peak, real queries) over the
device time of the top-k's hand-written kernels (csrc/, orag::) in the
window, in %."""

from portbench import readers


def read(run):
    return readers.topk_roofline(run)
