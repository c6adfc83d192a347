"""decode_roofline.gen: the least time of the window's decode steps over
their device time, in %. A step's least time is the larger of its bytes at
3.35 TB/s and its FLOPs at the bf16 peak (``systems/generator_work.py``):
the weights but the routed experts, the experts its tokens hit (the
program's routing counter) and the latent cache at its real positions."""

from portbench.systems import generator_work as gw
from portbench.systems.generator import window_calls


def read(run):
    cfg = run.cell.cfg
    least = device = 0.0
    for top, _, dec in window_calls(run):
        hit, ms = dec.attrs.get("experts_hit"), dec.attrs.get("device_ms")
        if not hit or ms is None:
            continue
        b, real = top.attrs["B"], top.attrs["prompt_tokens"]
        least += sum(gw.decode_step_bound_ms(cfg, h, b, real + b * (t + 1))
                     for t, h in enumerate(hit))
        device += ms
    return 100.0 * least / device if device else None
