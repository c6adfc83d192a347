"""encode_fetch_ms.qps: mean host ms of encode.fetch per
EmbeddingService.encode call that starts in the window (the program's
spans): the wait for the device and the copy of the vectors back."""

from portbench import program_spans


def read(run):
    return program_spans.child_ms(run, "encode", "encode.fetch")
