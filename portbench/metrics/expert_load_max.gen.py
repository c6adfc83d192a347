"""expert_load_max.gen: the prefill's most-loaded routed expert over the
mean per expert (tokens routed to it, from the program's routing counter),
averaged over the MoE layers and the window's calls."""

from portbench.systems.generator import window_calls


def read(run):
    ratios = []
    for _, pre, _ in window_calls(run):
        for counts in pre.attrs.get("expert_tokens") or []:
            mean = sum(counts) / len(counts)
            if mean:
                ratios.append(max(counts) / mean)
    return sum(ratios) / len(ratios) if ratios else None
