"""encode_upload_ms.qps: mean host ms of encode.upload per
EmbeddingService.encode call that starts in the window (the program's
spans): the tokens' copy to the device, which waits for the work queued on
its stream."""

from portbench import program_spans


def read(run):
    return program_spans.child_ms(run, "encode", "encode.upload")
