"""Hard-negative retrieval gauntlet: an encoder instrument that can fail.

Held against ``optimized_rag_tpu/eval/encoder_gauntlet.py`` (:1-198), of
which it is a copy over the port's ``LexicalIndex``, ``DenseIndex``,
``EmbeddingService``, ``models/pretrain`` and ``models/corpus``;
``build_gauntlet``, ``run_gauntlet`` and ``main`` also take a device
("cuda" by default, or "cpu"): the BM25 channels and the dense channel run
there, the dense one as ``DenseIndex.search``, so on the card the queries
run the top-k kernels. The pool is the harvest of the machine it
runs on (``models/corpus.harvest_all`` finds installed packages), so two
machines give comparable numbers only where their harvests are equal.

With the QA sheet saturated and the 300-chunk ICT holdout near 0.89,
nothing self-authored could drive encoder work further. This module is the
replacement instrument:

  * >=1,000 ICT queries drawn ONLY from the shared holdout chunks the
    bundled encoder never trained on (prose[:300] of the harvest);
  * each query's index is salted with BM25-CONFUSABLE hard negatives —
    chunks from the full harvest pool that score highest on the query's
    own terms but are not its source — so lexical overlap alone cannot
    win; the encoder must use span context;
  * recall@10 (and @1) of the dense channel, with the BM25 channel's
    recall on the identical setup reported for contrast.

The published baseline (docs/results_r5/gauntlet.json) is the number
future encoder training must move.

Run:  python -m optimized_rag_tpu_torch.eval.encoder_gauntlet
      [--device cpu] [--json F]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

_WORDS = re.compile(r"[\w#]+")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sample_spans(rng: np.random.Generator, text: str, n: int,
                 min_span: int = 3, max_span: int = 8) -> List[str]:
    """Up to ``n`` distinct ICT word spans from one chunk."""
    words = _WORDS.findall(text.lower())
    if len(words) < min_span:
        return []
    out, seen = [], set()
    for _ in range(4 * n):
        if len(out) >= n:
            break
        span = int(rng.integers(min_span, max_span + 1))
        start = int(rng.integers(0, max(len(words) - span, 0) + 1))
        q = " ".join(words[start:start + span])
        if q not in seen:
            seen.add(q)
            out.append(q)
    return out


def build_gauntlet(pool: Sequence[str], gold: Sequence[str],
                   spans_per_chunk: int = 3, negatives_per_query: int = 8,
                   seed: int = 7, device="cuda"):
    """Returns (queries, gold_ids, index_texts); the BM25 mining runs on
    ``device``.

    ``index_texts`` = gold chunks + the union of per-query BM25 hard
    negatives mined from ``pool``; ``gold_ids[i]`` is the index row of
    query i's source chunk.
    """
    from optimized_rag_tpu_torch.index.lexical import LexicalIndex

    rng = np.random.default_rng(seed)
    lex = LexicalIndex(cap=max(1024, len(pool)), device=device)
    lex.add(list(pool))
    lex.build()

    queries: List[str] = []
    q_gold: List[int] = []
    for gi, chunk in enumerate(gold):
        for q in sample_spans(rng, chunk, spans_per_chunk):
            queries.append(q)
            q_gold.append(gi)

    neg_rows: set = set()
    t0 = time.time()
    for qi, q in enumerate(queries):
        s, ids = lex.search(q, k=negatives_per_query + 2)
        for r in np.asarray(ids).tolist():
            if r >= 0:
                neg_rows.add(int(r))
        if qi % 200 == 199:
            log(f"mined negatives for {qi + 1}/{len(queries)} queries "
                f"({time.time() - t0:.0f}s)")
    gold_set = set(gold)
    negatives = [pool[r] for r in sorted(neg_rows)
                 if pool[r] not in gold_set]
    index_texts = list(gold) + negatives
    return queries, q_gold, index_texts


def run_gauntlet(service=None, n_gold: int = 300,
                 spans_per_chunk: int = 4, negatives_per_query: int = 8,
                 pool_chunks: int = 30000, seed: int = 7,
                 k: int = 10, device="cuda") -> Dict:
    """Builds the gauntlet from the shared-holdout derivation and scores
    the given embedding service (default: the bundled checkpoint on
    ``device``) with a ``DenseIndex`` on the service's device."""
    import os

    from optimized_rag_tpu_torch.index.dense import DenseIndex
    from optimized_rag_tpu_torch.index.lexical import LexicalIndex
    from optimized_rag_tpu_torch.models import pretrain
    from optimized_rag_tpu_torch.models.corpus import harvest_all
    from optimized_rag_tpu_torch.models.encoder import EmbeddingService

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if service is None:
        ck = os.path.join(repo, "checkpoints", "pretrained")
        cfg, params = pretrain.load_pretrained(ck, "biencoder")
        service = EmbeddingService(
            cfg, params=params, max_len=64, cache_size=0,
            tokenizer=pretrain.load_tokenizer(ck, cfg.vocab_size, 64),
            device=device)

    big = harvest_all(max_chunks=pool_chunks, extra_dirs=[repo])
    prose = [t for t in big if "def " not in t and "self." not in t]
    # Shared-holdout derivation (benchmarks/compare_encoders.py /
    # retrain_biencoder_xl.py): the bundled xl2 encoder trained on the
    # corpus MINUS prose[:300]. Gold must come from the untrained
    # prefix; the pool (negatives) may include trained chunks — they
    # are distractors, and familiarity only makes them harder to
    # reject.
    gold = prose[:min(n_gold, 300)]
    pool = prose[300:]
    log(f"gauntlet: {len(gold)} gold holdout chunks, "
        f"{len(pool)}-chunk mining pool")

    queries, q_gold, index_texts = build_gauntlet(
        pool, gold, spans_per_chunk=spans_per_chunk,
        negatives_per_query=negatives_per_query, seed=seed,
        device=service.device)
    log(f"gauntlet: {len(queries)} queries over a "
        f"{len(index_texts)}-chunk index "
        f"({len(index_texts) - len(gold)} hard negatives)")

    # Dense channel.
    idx = DenseIndex(dim=service.dim, capacity_block=1 << 12, tile=1024,
                     device=service.device)
    t0 = time.time()
    for i in range(0, len(index_texts), 512):
        idx.add(service.encode(index_texts[i:i + 512]))
    log(f"encoded index in {time.time() - t0:.0f}s")
    hits1 = hits = 0
    bs = 256
    for i in range(0, len(queries), bs):
        ids = np.asarray(idx.search(service.encode(queries[i:i + bs]),
                                    k=k).ids)
        for row, want in zip(ids, q_gold[i:i + bs]):
            hits += int(want in row.tolist())
            hits1 += int(row[0] == want)

    # BM25 contrast channel on the identical index.
    lex = LexicalIndex(cap=max(1024, len(index_texts)),
                       device=service.device)
    lex.add(index_texts)
    lex.build()
    bm_hits = 0
    for q, want in zip(queries, q_gold):
        _, ids = lex.search(q, k=k)
        bm_hits += int(want in np.asarray(ids).tolist())

    n = len(queries)
    out = {
        "n_queries": n,
        "index_size": len(index_texts),
        "gold_chunks": len(gold),
        "negatives_per_query": negatives_per_query,
        "recall_at_10_dense": round(hits / n, 4),
        "recall_at_1_dense": round(hits1 / n, 4),
        "recall_at_10_bm25": round(bm_hits / n, 4),
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", dest="json_out", default=None)
    ap.add_argument("--gold", type=int, default=300)
    ap.add_argument("--spans", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="device to run on: cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run_gauntlet(n_gold=args.gold, spans_per_chunk=args.spans,
                       device=args.device)
    print(json.dumps(out, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
