"""The comparison that decides ``correct``.

After the window has closed and the program's state is freed, the check
walks the corpus again, block by block, as the benchmark made it: the
reference normalises each block and rounds it to the storage dtype the
configuration states (``reference.topk.store``), and holds what the timed
path returned against it in float64:

* ``missing``: requests or queries of the window with no answer, an error,
  fewer than k ids, an id of -1 or an id twice (limit 0);
* ``score_err``: over every answer of the window, the largest gap between
  a returned score and the float64 score of its id with the query vector
  the index searched;
* ``rank_gap``: over a sample drawn from the seed, the largest amount by
  which the j-th best float64 score of that query vector lies above the
  j-th best score of the ids returned (a wrong or missing id shows here);

and, where the traffic sends texts (the query vectors are then the
encoder's output, which is judged too):

* ``enc_err``: over the sample, the largest L2 distance between the
  program's query vector and the plain float32 encoder's
  (``reference.encoder``) for the same text;
* ``e2e_gap``: ``rank_gap`` with the plain encoder's query vector: the
  whole path against the whole reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.corpus.clustered import stream_seed
from portbench.reference.topk import RunningTopK, scores_of, store

SAMPLE = 2048


@dataclass
class Answers:
    queries: torch.Tensor | None    # [Q, D] the vectors the index searched
    texts: list[str] | None         # [Q] the texts they embed, if any
    qidx: np.ndarray                # [A] query of each answer
    scores: np.ndarray              # [A, k]
    ids: np.ndarray                 # [A, k]
    k: int
    missing: int

    @classmethod
    def build(cls, queries, texts, k, scores, ids, missing, qidx=None):
        if not len(scores):
            return cls(None, None, np.zeros(0, np.int64),
                       np.zeros((0, k), np.float32),
                       np.zeros((0, k), np.int64), k, missing)
        sc = np.concatenate([np.atleast_2d(s) for s in scores])
        ii = np.concatenate([np.atleast_2d(i) for i in ids])
        q = torch.as_tensor(queries)
        if qidx is None:
            qidx = np.arange(sc.shape[0])
        return cls(q, texts, np.asarray(qidx, np.int64), sc, ii, k, missing)


def malformed(ans: Answers) -> int:
    """Answers with fewer than k ids, an id of -1 or an id twice."""
    if ans.ids.shape[1] < ans.k:
        return ans.ids.shape[0]
    ids = np.sort(ans.ids, axis=1)
    bad = (ids[:, 0] < 0) | (np.diff(ids, axis=1) == 0).any(axis=1)
    return int(bad.sum())


def _desc(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1, descending=True).values


def compare(cfg: dict, corpus, ans: Answers, seed: int, device,
            encoder=None) -> dict:
    """The numbers compared, by name. ``encoder`` is the plain encoder and
    its tokenizer, for traffic that sends texts."""
    dev = torch.device(device)
    out = {"missing": ans.missing + malformed(ans)}
    a = ans.ids.shape[0]
    if a == 0:
        out["missing"] = max(out["missing"], 1)
        return out
    k = ans.k
    q = ans.queries.to(dev).double()
    q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    rng = np.random.default_rng(stream_seed(seed, 20))
    pick = np.sort(rng.choice(a, size=min(a, SAMPLE), replace=False))
    qidx = torch.from_numpy(ans.qidx).to(dev)
    ids = torch.from_numpy(ans.ids[:, :k].astype(np.int64)).to(dev)
    flat_q = qidx[:, None].expand(-1, k).reshape(-1)
    flat_i = ids.reshape(-1)
    true = torch.zeros(flat_i.shape[0], dtype=torch.float64, device=dev)
    pick_t = torch.from_numpy(pick).to(dev)
    top = RunningTopK(q[qidx[pick_t]], k)
    ref = None
    if ans.texts is not None and encoder is not None:
        model, tok = encoder
        texts = [ans.texts[int(ans.qidx[i])] for i in pick]
        ref_q = model.encode(tok, texts, int(cfg["encoder"]["max_len"])
                             ).double()
        out["enc_err"] = float((ref_q - q[qidx[pick_t]]).norm(dim=1).max())
        ref = RunningTopK(ref_q, k)
        ref_true = torch.zeros(len(pick) * k, dtype=torch.float64,
                               device=dev)
        ref_qidx = torch.arange(len(pick), device=dev)[:, None].expand(
            -1, k).reshape(-1)
        ref_ids = ids[pick_t].reshape(-1)
    dtype = cfg["index"]["dtype"]
    for first, rows in corpus.blocks():
        r64 = store(rows, dtype)
        top.feed(r64, first)
        scores_of(q, flat_q, flat_i, r64, first, true)
        if ref is not None:
            ref.feed(r64, first)
            scores_of(ref_q, ref_qidx, ref_ids, r64, first, ref_true)
        del r64
    served = torch.from_numpy(ans.scores[:, :k].astype(np.float64)).to(dev)
    out["score_err"] = float((served.reshape(-1) - true).abs().max())
    true = true.view(a, k)[pick_t]
    out["rank_gap"] = float((top.scores - _desc(true)).max())
    if ref is not None:
        out["e2e_gap"] = float((ref.scores - _desc(ref_true.view(-1, k))
                                ).max())
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit; a number without a limit, or a
    limit without its number, fails."""
    if set(numbers) != set(limits):
        return False
    return all(np.isfinite(v) and v <= limits[n] for n, v in numbers.items())
