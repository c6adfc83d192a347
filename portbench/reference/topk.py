"""Plain exact top-k in float64, over rows handed in block by block.

The reference normalises the rows it is given itself and rounds them to
the storage dtype the configuration states, as stored rows are; scores are
float64 products of those rows with the float64 queries. ``store`` is also
the control's storage: int8 codes with one float32 scale a row (amax to
127), the step below bfloat16.
"""

from __future__ import annotations

import torch

_STORE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def unit(x: torch.Tensor) -> torch.Tensor:
    """Float32 rows divided by their L2 norm (floor 1e-12)."""
    x = x.float()
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)).clamp_min(
        1e-12)


def store(rows: torch.Tensor, dtype: str) -> torch.Tensor:
    """Unit rows as the index would hold them, back in float64."""
    u = unit(rows)
    if dtype == "int8":
        scale = u.abs().amax(dim=1, keepdim=True).clamp_min(1e-30) / 127.0
        return (torch.round(u / scale).clamp(-127, 127) * scale).double()
    return u.to(_STORE[dtype]).double()


class RunningTopK:
    """Exact top-k of ``queries`` [S, D] over row blocks fed in order of
    their first row, scored in ``dtype`` (float64; the control passes
    float32); ``sub`` rows are scored at a time. Of equal scores either row
    may be kept: the comparison reads scores alone."""

    def __init__(self, queries: torch.Tensor, k: int, sub: int = 131072,
                 dtype=torch.float64):
        self.q = queries.to(dtype)
        self.k = k
        self.sub = sub
        s = queries.shape[0]
        dev = queries.device
        self.scores = torch.full((s, k), float("-inf"), dtype=dtype,
                                 device=dev)
        self.ids = torch.full((s, k), -1, dtype=torch.long, device=dev)

    def feed(self, rows64: torch.Tensor, first_row: int) -> None:
        for lo in range(0, rows64.shape[0], self.sub):
            part = rows64[lo:lo + self.sub]
            v, i = torch.topk(self.q @ part.to(self.q.dtype).T,
                              min(self.k, part.shape[0]), dim=1)
            all_s = torch.cat([self.scores, v], dim=1)
            all_i = torch.cat([self.ids, i + first_row + lo], dim=1)
            self.scores, o = torch.topk(all_s, self.k, dim=1)
            self.ids = torch.gather(all_i, 1, o)


def scores_of(queries64: torch.Tensor, qidx: torch.Tensor, ids: torch.Tensor,
              rows64: torch.Tensor, first_row: int,
              out: torch.Tensor) -> None:
    """Writes into ``out`` [A] the float64 score of each answer a, the pair
    (query ``qidx[a]`` of ``queries64``, row ``ids[a]``), whose row lies in
    this block."""
    inside = (ids >= first_row) & (ids < first_row + rows64.shape[0])
    pos = torch.nonzero(inside).squeeze(1)
    if pos.numel():
        out[pos] = (queries64[qidx[pos]] * rows64[ids[pos] - first_row]
                    ).sum(dim=1)
