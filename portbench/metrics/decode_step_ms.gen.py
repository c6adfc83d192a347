"""decode_step_ms.gen: device ms of one decode step: the window's decode
device time (the program's ``generate.decode`` spans) over its steps."""

from portbench.systems.generator import window_calls


def read(run):
    ms = steps = 0
    for _, _, dec in window_calls(run):
        if dec.attrs.get("device_ms") is None or not dec.attrs.get("steps"):
            continue
        ms += dec.attrs["device_ms"]
        steps += dec.attrs["steps"]
    return ms / steps if steps else None
