"""Clustered unit rows with runs of near-duplicates, made on the device.

Frozen copies (commit 6ca9d44): ``clustered_rows``, ``near_duplicates``,
``plan_runs`` and the block loop of ``fill_index``
(``chip_smoke.py:394-415, 942-973``), which put ``benchmarks/common.py:40-76``'s
corpus (cluster centre times 2 plus unit noise, normalised) in torch.
Parameters come from the configuration's ``corpus`` entry:

* ``rows``, ``dim``, ``clusters``: the corpus' size and its centres;
* ``runs``, ``run_len``: runs of near-duplicates (cosine about 0.98 to
  their base), 32-row aligned, of ``run_len[0]..run_len[1]`` rows;
* ``base``: ``"qa_docs"`` puts the embeddings of the frozen qa_docs chunks
  first, and bases the first two runs per chunk on them; ``null`` puts
  none.

The same seed and device give the same rows. ``blocks()`` can be walked
again, which the check does after the program's state is freed.
"""

from __future__ import annotations

import random

import torch

BLOCK = 1 << 20


def unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)).clamp_min(
        1e-12)


def clustered_rows(n, gen, centers):
    dev = centers.device
    assign = torch.randint(0, centers.shape[0], (n,), generator=gen,
                           device=dev)
    return unit(centers[assign] + torch.randn(n, centers.shape[1],
                                              generator=gen, device=dev))


def near_duplicates(base, n, gen):
    noise = unit(torch.randn(n, base.shape[0], generator=gen,
                             device=base.device))
    return unit(base[None, :] + 0.2 * noise)


def plan_runs(rng: random.Random, n_rows, first_row, n_runs, run_len):
    slots = rng.sample(range(-(-first_row // 32), n_rows // 32), n_runs)
    return sorted((s * 32, rng.randint(*run_len)) for s in slots)


def stream_seed(seed: int, label: int) -> int:
    """A seed of its own for each stream drawn from one run seed."""
    return (int(seed) * 1_000_003 + label) % (1 << 63)


class Corpus:
    def __init__(self, spec: dict, seed: int, device, base_rows=None):
        self.rows = int(spec["rows"])
        self.dim = int(spec["dim"])
        self.clusters = int(spec["clusters"])
        self.n_runs = int(spec.get("runs", 0))
        self.run_len = tuple(spec.get("run_len", (8, 32)))
        self.seed = seed
        self.device = torch.device(device)
        # Base rows (the qa_docs chunks' reference embeddings) are made once
        # by the caller and kept: they are inputs both sides are handed.
        self.base = base_rows
        gen = torch.Generator(device=self.device).manual_seed(
            stream_seed(seed, 1))
        self.centers = torch.randn(self.clusters, self.dim, generator=gen,
                                   device=self.device) * 2.0
        self._gen_state = gen.get_state()
        first = 0 if base_rows is None else base_rows.shape[0]
        rng = random.Random(stream_seed(seed, 2))
        self.runs = (plan_runs(rng, self.rows, first, self.n_runs,
                               self.run_len) if self.n_runs else [])
        nb = 0 if base_rows is None else base_rows.shape[0]
        order = rng.sample(self.runs, len(self.runs))
        self.bases = {start: (j % nb if j < 2 * nb else None)
                      for j, (start, _) in enumerate(order)}

    def blocks(self):
        """(first_row, float32 unit rows) in order, base rows first."""
        gen = torch.Generator(device=self.device)
        gen.set_state(self._gen_state)
        first = 0
        if self.base is not None:
            yield 0, self.base
            first = self.base.shape[0]
        for lo in range(0, self.rows, BLOCK):
            lo_, hi = max(lo, first), min(self.rows, lo + BLOCK)
            if hi <= lo_:
                continue
            x = clustered_rows(hi - lo_, gen, self.centers)
            for start, length in self.runs:
                if lo_ <= start < hi:
                    b = self.bases[start]
                    base = x[start - lo_] if b is None else self.base[b]
                    x[start - lo_:start - lo_ + length] = near_duplicates(
                        base, length, gen)
            yield lo_, x

    def queries(self, n: int, label: int) -> torch.Tensor:
        """``n`` unit rows drawn as the corpus rows are, near its clusters,
        from a stream of their own."""
        gen = torch.Generator(device=self.device).manual_seed(
            stream_seed(self.seed, 100 + label))
        return clustered_rows(n, gen, self.centers)
