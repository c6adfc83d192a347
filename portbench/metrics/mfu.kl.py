"""mfu.kl: the window's model FLOPs over real tokens at the bf16 peak
(989 TFLOP/s) over the window's length, in %: each call's prefill over its
prompts' real tokens (MLA attention causal and expanded, KDA in its
chunked form) and its decode tokens, for this rank's share
(``systems/kimi_linear_work.py``)."""

from portbench.systems import kimi_linear_work as kw


def read(run):
    d, cfg = run.load, run.cell.cfg
    if not d.calls:
        return None
    flops = 0.0
    for p, _, _, out in d.calls:
        lengths = (d.pool.shape[2] - d.pad[p]).tolist()
        b, real = len(lengths), sum(lengths)
        flops += kw.prefill_flops(cfg, lengths)
        flops += sum(kw.decode_step_flops(cfg, b, real + b * (t + 1))
                     for t in range(out.tokens.shape[0] - 1))
    return 100.0 * flops / kw.PEAK["bfloat16"] / (d.t1 - d.t0)
