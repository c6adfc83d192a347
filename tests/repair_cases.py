"""Corpora whose certificate fails, for the tests of the certified path's
repair (``ops.topk.repair_uncovered``): near-duplicate runs of each query
split across tiles, as same-document chunks land in several tiles, so more
tiles are suspicious across the batch than the union covers (c2 pairs); with
``c3``, query 0 has near-copies in more tiles than c1 rescores, so its best
excluded candidate beats tau as well (a c3 query)."""

import numpy as np


def unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def runs_corpus(rng, b, d, tile, tiles, per_query=4, run=3, c3=False):
    """(queries [b, d], rows [tile * tiles, d]), unit float32: a chunk near
    each query, stored ``run`` times over in each of ``per_query`` tiles
    spread over the corpus (copies in two units of a tile make its second
    unit tie its best); with ``c3``, query 0's single near-copies in 40
    more tiles."""
    q = unit(rng, b, d)
    c = rng.standard_normal((tile * tiles, d)).astype(np.float32) * 0.3
    for bi in range(b):
        chunk = q[bi] + 0.05 * rng.standard_normal(d)
        for j in range(per_query):
            t = (bi * 5 + j * (tiles // per_query) + 1) % tiles
            at = t * tile + (bi * run + 7 * j) % (tile - run)
            c[at:at + run] = chunk
    if c3:
        for j in range(40):
            at = ((3 * j + 2) % tiles) * tile + tile - 1
            c[at] = q[0] + 0.002 * rng.standard_normal(d)
    return q, c / np.linalg.norm(c, axis=1, keepdims=True)
