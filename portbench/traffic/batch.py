"""Batch top-k: back-to-back ``DenseIndex.search`` calls of ``batch``
query vectors each, for ``k`` results.

Parameters (the mix's file): ``batch``, ``k``, ``pool`` (batches made in
set-up and cycled). The query vectors are drawn as the corpus rows are,
near its clusters (embedded queries lie near their documents), on the
device from the seed. Set-up searches the pool's first batch once. The
window starts calls until ``seconds`` have passed and ends when the last
returns.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class Load:
    def __init__(self, system, mix: dict, seed: int):
        self.system = system
        self.mix = mix
        self.k = int(mix["k"])
        b, pool = int(mix["batch"]), int(mix["pool"])
        self.pool = torch.stack([system.corpus.queries(b, label=i)
                                 for i in range(pool)])
        self.calls: list[tuple] = []    # (pool index, t0, t1, scores, ids)
        self.failed = 0
        self.t0 = self.t1 = 0.0
        self.on_open = self.on_close = lambda: None

    def warm_shapes(self) -> None:
        """One call: every batch of the pool has the same shape."""
        self.system.index.search(self.pool[0], self.k)

    def run(self, seconds: float) -> None:
        index = self.system.search_index
        self.on_open()
        self.t0 = time.perf_counter()
        end = self.t0 + seconds
        i, now = 0, self.t0
        while now < end:
            p = i % self.pool.shape[0]
            try:
                res = index.search(self.pool[p], self.k)
                t1 = time.perf_counter()
                self.calls.append((p, now, t1, res.scores, res.ids))
            except Exception:               # counted as failed
                t1 = time.perf_counter()
                self.failed += 1
            now = t1
            i += 1
        self.t1 = now
        self.on_close()

    @property
    def attempted(self) -> int:
        return (len(self.calls) + self.failed) * self.pool.shape[1]

    def answers(self):
        from portbench.check import Answers
        b = self.pool.shape[1]
        if not self.calls:
            return Answers.build(queries=None, texts=None, k=self.k,
                                 scores=[], ids=[],
                                 missing=self.failed * b)
        qidx = np.concatenate([p * b + np.arange(b) for p, *_ in self.calls])
        return Answers.build(
            queries=self.pool.reshape(-1, self.pool.shape[2]), texts=None,
            k=self.k, scores=[c[3] for c in self.calls],
            ids=[c[4] for c in self.calls], missing=self.failed * b,
            qidx=qidx)
