"""prefill_ms.gen: mean device ms of a call's prefill (the program's
``generate.prefill`` span: a CUDA event pair read after the call)."""

from portbench.systems.generator import window_calls


def read(run):
    ms = [pre.attrs.get("device_ms") for _, pre, _ in window_calls(run)]
    ms = [m for m in ms if m is not None]
    return sum(ms) / len(ms) if ms else None
