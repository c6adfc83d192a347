"""mfu.gen: the window's model FLOPs over real tokens at the bf16 peak
(989 TFLOP/s) over the window's length, in %: each call's prefill over its
prompts' real tokens (attention causal, in the expanded form) and its
decode tokens (``systems/generator_work.py``)."""

from portbench.systems import generator_work as gw


def read(run):
    d, cfg = run.load, run.cell.cfg
    if not d.calls:
        return None
    flops = 0.0
    for p, _, _, out in d.calls:
        lengths = (d.pool.shape[2] - d.pad[p]).tolist()
        b, real = len(lengths), sum(lengths)
        flops += gw.prefill_flops(cfg, lengths)
        flops += sum(gw.decode_step_flops(cfg, b, real + b * (t + 1))
                     for t in range(out.tokens.shape[0] - 1))
    return 100.0 * flops / gw.PEAK["bfloat16"] / (d.t1 - d.t0)
