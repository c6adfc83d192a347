"""kda_roofline.kl: the least time of the window's KDA walks over chunks
over the device time of the walk's kernel (``kda::chunk_state_kernel``,
from the device trace), in %. A walk's least time is the larger of its
bytes at 3.35 TB/s and its FLOPs at the bf16 peak, counted for each call's
prompts' real tokens in every KDA layer (``systems/kimi_linear_work.py``);
the count is the same whatever implements the walk."""

from portbench.systems import kimi_linear_work as kw

KERNEL = "kda::chunk_state_kernel"


def read(run):
    if run.trace is None:
        return None
    ns = sum(v for n, v in run.trace["by_name_ns"].items() if KERNEL in n)
    d, cfg = run.load, run.cell.cfg
    if not ns or not d.calls:
        return None
    layers = kw.counts(cfg)[0]
    least = sum(layers * kw.kda_walk_bound_ms(
        cfg, (d.pool.shape[2] - d.pad[p]).tolist()) for p, *_ in d.calls)
    return 100.0 * least / (ns / 1e6)
