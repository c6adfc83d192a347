"""setup_s: seconds from process start to the window's first request,
compilation and warm-up included."""


def read(run):
    return run.setup_s
