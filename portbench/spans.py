"""Spans around the calls into the program's layers, from the benchmark's
own wrappers.

Each wrapped call returns numpy, so it has waited for the device, and its
host-clock span covers the device work it caused.
"""

from __future__ import annotations

import threading
import time

import numpy as np


def real_rows(q: np.ndarray) -> int:
    """Rows of a query batch that are not padding: ``QueryServer`` pads a
    batch by repeating its last query, and no query of the traffic repeats."""
    n = q.shape[0]
    last = q[-1]
    pad = 0
    while pad + 1 < n and np.array_equal(q[n - 2 - pad], last):
        pad += 1
    return n - pad


class Spans:
    def __init__(self):
        # Host-clock spans (time.perf_counter).
        self.encode: list[tuple] = []   # (t0, t1, texts, embeddings)
        self.search: list[tuple] = []   # (t0, t1, real_b, k, route)
        self.lock = threading.Lock()

    def wrap_encode(self, encode):
        def embed_fn(texts):
            t0 = time.perf_counter()
            out = encode(texts)
            t1 = time.perf_counter()
            with self.lock:
                self.encode.append((t0, t1, texts, out))
            return out
        return embed_fn

    def wrap_index(self, index):
        return _SpannedIndex(index, self)


class _SpannedIndex:
    """Passes every attribute to the index; ``search`` is timed."""

    def __init__(self, index, spans: Spans):
        self._index = index
        self._spans = spans

    def __getattr__(self, name):
        return getattr(self._index, name)

    def search(self, queries, k, **kw):
        sp = self._spans
        b = (real_rows(queries) if isinstance(queries, np.ndarray)
             else int(queries.shape[0]))
        t0 = time.perf_counter()
        res = self._index.search(queries, k, **kw)
        t1 = time.perf_counter()
        with sp.lock:
            sp.search.append((t0, t1, b, k, res.route))
        return res
