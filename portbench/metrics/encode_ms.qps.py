"""encode_ms.qps: mean host time of one EmbeddingService.encode call that
starts in the window (it returns numpy, so the device work is in it)."""

from portbench import readers


def read(run):
    return readers.mean_ms(run, "encode")
