"""encode_launch_ms.qps: mean host ms of encode.forward per
EmbeddingService.encode call that starts in the window (the program's
spans): the module call, the forward issued (no wait for the device)."""

from portbench import program_spans


def read(run):
    return program_spans.child_ms(run, "encode", "encode.forward")
