"""tokenize_ms.qps: mean host ms of encode.tokenize per EmbeddingService.encode
call that starts in the window (the program's spans): the texts'
tokenisation and padding."""

from portbench import program_spans


def read(run):
    return program_spans.child_ms(run, "encode", "encode.tokenize")
