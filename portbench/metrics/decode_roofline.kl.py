"""decode_roofline.kl: the least time of the window's decode steps over
their device time, in %. A step's least time is the larger of its bytes at
3.35 TB/s and its FLOPs at the bf16 peak (``systems/kimi_linear_work.py``):
the weights but the routed experts and the embedding, the held experts its
tokens hit (the program's routing counter), the latent cache of the MLA
layers at its real positions, and the KDA state read once and written
once."""

from portbench.systems import kimi_linear_work as kw
from portbench.systems.generator import window_calls


def read(run):
    cfg = run.cell.cfg
    least = device = 0.0
    for top, _, dec in window_calls(run):
        hit, ms = dec.attrs.get("experts_hit"), dec.attrs.get("device_ms")
        if not hit or ms is None:
            continue
        b, real = top.attrs["B"], top.attrs["prompt_tokens"]
        least += sum(kw.decode_step_bound_ms(cfg, h, b, real + b * (t + 1))
                     for t, h in enumerate(hit))
        device += ms
    return 100.0 * least / device if device else None
