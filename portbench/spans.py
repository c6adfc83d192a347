"""Spans around the calls into the program's layers, from the benchmark's
own wrappers, kept by layer.

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


def layers(spans) -> dict[str, list]:
    """Each layer's spans by the layer's name: the lists ``spans`` holds."""
    return {k: v for k, v in vars(spans).items() if isinstance(v, list)}


class Spans:
    """Host-clock spans (time.perf_counter), each starting (t0, t1, ...),
    in one list a layer, held as the attribute of the layer's name. The
    wrappers below record ``encode`` (t0, t1, texts, embeddings) and
    ``search`` (t0, t1, real_b, k, route); a kind of system records its own
    layers with ``add``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.encode: list[tuple] = []
        self.search: list[tuple] = []

    def add(self, layer: str, span: tuple) -> None:
        held = getattr(self, layer, None)
        if held is not None and not isinstance(held, list):
            raise ValueError(f"{layer!r} is no layer's name")
        with self.lock:
            vars(self).setdefault(layer, []).append(span)

    def wrap_encode(self, encode):
        def embed_fn(texts):
            t0 = time.perf_counter()
            out = encode(texts)
            t1 = time.perf_counter()
            self.add("encode", (t0, t1, texts, out))
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
        sp.add("search", (t0, t1, b, k, res.route))
        return res
