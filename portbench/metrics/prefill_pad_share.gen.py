"""prefill_pad_share.gen: the share of the positions the window's
prefills computed that are padding, in % (the program's
``generate.prefill`` counts: positions computed, real prompt tokens)."""

from portbench.systems.generator import window_calls


def read(run):
    tokens = real = 0
    for _, pre, _ in window_calls(run):
        tokens += pre.attrs.get("tokens", 0)
        real += pre.attrs.get("real", 0)
    return 100.0 * (tokens - real) / tokens if tokens else None
