"""Hybrid retriever: dense + BM25 + temporal fusion on the device.

Held against ``optimized_rag_tpu/engine/retriever.py``. The hybrid score
``alpha*semantic + beta*bm25 + gamma*recency`` (recency
0.5^(age_days/half_life)) runs by one of three routes:

  * one call (ops/fused_query.py) when an encoder service is given and
    the dense index is clean: encoder forward, both channels, union and
    fusion, one host copy;
  * two calls (ops/hybrid.py) without an encoder: ``dual_topk``, then
    ``fuse_candidates`` over the union;
  * separate calls when the index has tombstones or an ANN overlay:
    ``DenseIndex.search`` (the top-k kernels on the card) or the ANN
    candidates, and ``LexicalIndex.search``, then ``fuse_candidates``.

Intents whose strategy has ``use_hybrid=False`` go to ``dense_only``
(``DenseIndex.search``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from optimized_rag_tpu_torch.engine.types import (
    Intent, RetrievedDoc, Source, intent_weights, retrieval_strategy)
from optimized_rag_tpu_torch.ops.topk import NEG_INF

NEG_INF_HALF = NEG_INF / 2


class HybridRetriever:
    """Multi-channel retrieval over one corpus (documents, archival, ...).

    ``get_text``/``get_created_at`` map doc ids to payloads; ``encoder``
    (an EmbeddingService) turns on the one-call route.
    """

    def __init__(self, dense, lexical, embed_fn: Callable[[List[str]],
                                                          np.ndarray],
                 get_text: Callable[[int], str],
                 get_created_at: Optional[Callable[[int], float]] = None,
                 half_life_days: float = 30.0,
                 source: Source = Source.DOCUMENTS,
                 candidate_k: int = 50,
                 encoder=None):
        self.dense = dense
        self.encoder = encoder
        self._created_dev = None   # [capacity] days since the epoch
        self._created_n = 0
        self._created_cap = 0
        self._created_epoch = 0    # DenseIndex.epoch the cache was built at
        # Optional ANN candidate source covering rows [0, ann_size); the
        # exact DenseIndex covers the tail added since, and candidates are
        # the union.
        self.ann = None
        self.ann_size = 0
        self.lexical = lexical
        self.embed_fn = embed_fn
        self.get_text = get_text
        self.get_created_at = get_created_at
        self.half_life_days = half_life_days
        self.source = source
        self.candidate_k = candidate_k

    # ----------------------------------------------------------------- API

    def retrieve(self, query: str, top_k: int = 10,
                 intent: Intent | str | None = None,
                 weights: Optional[Dict[str, float]] = None,
                 query_embedding: Optional[np.ndarray] = None
                 ) -> List[RetrievedDoc]:
        """Hybrid retrieve honoring the per-intent strategy table."""
        strategy = retrieval_strategy(intent)
        if not strategy["use_hybrid"] or self.lexical is None \
                or self.lexical.size == 0:
            return self.dense_only(query, top_k, query_embedding)
        return self.hybrid_search(query, top_k, intent, weights,
                                  query_embedding)

    def _ann_candidates(self, q: np.ndarray, k: int):
        """ANN over the built segment unioned with exact search over the
        tail added since. Returns (scores [B, k], ids [B, k]).

        The ANN keeps its copy of every vector from before the build, so
        rows tombstoned since would come back at full score: oversample by
        the tombstone count and mask them out here."""
        dead = self.dense._tombstones
        kk = k + min(len(dead), max(0, self.ann_size - k))
        s1, i1 = self.ann.search(q, kk)
        tail = self.dense.search_tail(q, k, self.ann_size)
        s = np.concatenate([s1, tail.scores], axis=1)
        i = np.concatenate([np.asarray(i1, np.int64), tail.ids], axis=1)
        if dead:
            gone = np.isin(i, np.fromiter(dead, np.int64, len(dead)))
            s = np.where(gone, -np.inf, s)
            i = np.where(gone, np.int64(-1), i)
        order = np.argsort(-s, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(s, order, axis=1),
                np.take_along_axis(i, order, axis=1))

    def dense_only(self, query: str, top_k: int,
                   query_embedding: Optional[np.ndarray] = None
                   ) -> List[RetrievedDoc]:
        q = (query_embedding if query_embedding is not None
             else self.embed_fn([query]))
        q = np.atleast_2d(q)
        if self.ann is not None and self.ann_size > 0:
            scores, ids = self._ann_candidates(q, top_k)
        else:
            res = self.dense.search(q, k=top_k)
            scores, ids = res.scores, res.ids
        out = []
        for score, did in zip(scores[0], ids[0]):
            if did < 0 or not np.isfinite(score):
                continue
            out.append(self._mk(int(did), float(score),
                                semantic=float(score)))
        return out

    def _created_days(self) -> torch.Tensor:
        """Days since the epoch per dense row [capacity] float32 on the
        device, synced incrementally (only rows added since the last call
        are read). Rebuilt when the index's epoch moves: delete() and
        compact() remap row ids."""
        cap, n = self.dense.capacity, self.dense.size
        dev = self.dense.device
        epoch = getattr(self.dense, "epoch", 0)
        if epoch != self._created_epoch:
            self._created_dev = None
            self._created_n = 0
            self._created_epoch = epoch
        if self._created_dev is None or self._created_cap != cap:
            old = self._created_dev
            self._created_dev = torch.zeros(cap, device=dev)
            if old is not None and self._created_n > 0:
                self._created_dev[:self._created_n] = old[:self._created_n]
            self._created_cap = cap
        if self._created_n < n and self.get_created_at is not None:
            fresh = np.asarray(
                [self.get_created_at(i) / 86400.0
                 for i in range(self._created_n, n)], np.float32)
            self._created_dev[self._created_n:n] = torch.from_numpy(
                fresh).to(dev)
            self._created_n = n
        return self._created_dev

    def _weights(self, weights: Dict[str, float]) -> np.ndarray:
        w_tmp = (weights.get("temporal", 0.10)
                 if self.get_created_at is not None else 0.0)
        return np.asarray([weights.get("semantic", 0.55),
                           weights.get("keyword", 0.35), w_tmp], np.float32)

    def _lexical_arrays(self) -> dict:
        if self.lexical._device is None:
            self.lexical.build()
        return self.lexical._device

    def _fused_query(self, query: str, top_k: int,
                     weights: Dict[str, float]) -> List[RetrievedDoc]:
        """The one-call route (ops/fused_query.py). The query embedding
        comes back in the same result and goes to the encoder's cache, so
        later stages (rerank, eval) reuse it."""
        from optimized_rag_tpu_torch.ops.fused_query import (
            encode_and_retrieve)
        enc = self.encoder
        dvc = self._lexical_arrays()
        qt, qv = self.lexical.query_tensors(query)
        q_ids, q_mask = enc.tokenizer.encode_batch([query], enc.max_len)
        ck = min(max(self.candidate_k, top_k), self.dense.size)
        if self.get_created_at is not None:
            created = self._created_days()
        else:
            created = torch.zeros(self.dense.capacity,
                                  device=self.dense.device)
        k = min(top_k, 2 * ck)
        packed = encode_and_retrieve(
            enc.model, q_ids, q_mask,
            self.dense.embeddings(), self.dense.size,
            qt, qv, dvc["champ_docs"], dvc["champ_tf"], dvc["champ_valid"],
            dvc["idf"], dvc["doc_len"], dvc["avg_len"],
            created, time.time() / 86400.0,
            self._weights(weights), self.half_life_days,
            matryoshka_dim=enc.matryoshka_dim, candidate_k=ck, k=k,
            k1=self.lexical.k1, b=self.lexical.b,
            row_scale=self.dense.row_scale).cpu().numpy()
        enc.cache_put(query, packed[5, : enc.dim])
        out = []
        for col in range(k):
            did = int(packed[1, col])
            if did < 0 or packed[0, col] <= NEG_INF_HALF:
                continue
            out.append(self._mk(did, float(packed[0, col]),
                                semantic=float(packed[2, col]),
                                keyword=float(packed[3, col]),
                                temporal=float(packed[4, col])))
        return out

    def hybrid_search(self, query: str, top_k: int,
                      intent: Intent | str | None = None,
                      weights: Optional[Dict[str, float]] = None,
                      query_embedding: Optional[np.ndarray] = None
                      ) -> List[RetrievedDoc]:
        if weights is None:
            a, b, g = intent_weights(intent)
            weights = {"semantic": a, "keyword": b, "temporal": g}
        lexical_ok = self.lexical is not None and self.lexical.size > 0
        clean = (self.ann is None and not self.dense._tombstones
                 and self.dense.size > 0)
        if (self.encoder is not None and query_embedding is None
                and lexical_ok and clean):
            return self._fused_query(query, top_k, weights)
        ck = max(self.candidate_k, top_k)
        q = (query_embedding if query_embedding is not None
             else self.embed_fn([query]))
        q = np.atleast_2d(q)

        if lexical_ok and clean:
            # Both channels in one call (ops/hybrid.py).
            from optimized_rag_tpu_torch.ops.hybrid import dual_topk
            dvc = self._lexical_arrays()
            qt, qv = self.lexical.query_tensors(query)
            kk = min(ck, self.dense.size)
            qn0 = np.asarray(q, np.float32)
            qn0 = qn0 / np.maximum(
                np.linalg.norm(qn0, axis=1, keepdims=True), 1e-9)
            packed = dual_topk(
                qn0, self.dense.embeddings(), self.dense.size, qt, qv,
                dvc["champ_docs"], dvc["champ_tf"], dvc["champ_valid"],
                dvc["idf"], dvc["doc_len"], dvc["avg_len"],
                k=kk, k1=self.lexical.k1, b=self.lexical.b,
                row_scale=self.dense.row_scale).cpu().numpy()
            ds, di = packed[0, 0], packed[1, 0].astype(np.int64)
            bs, bi = packed[0, -1], packed[1, -1].astype(np.int64)
            dense_ids = [int(i) for s, i in zip(ds, di)
                         if i >= 0 and s > NEG_INF_HALF]
            lex_scores = {int(i): float(s)
                          for s, i in zip(bs, bi) if i >= 0 and s > 0.0}
        else:
            # Separate calls: tombstones force the index's oversample and
            # filter, or an ANN overlay supplies the dense candidates.
            kk = min(ck, max(self.dense.size, 1))
            if self.ann is not None and self.ann_size > 0:
                dscores, dids = self._ann_candidates(q, kk)
                dense_ids = [int(i) for s_, i in zip(dscores[0], dids[0])
                             if i >= 0 and np.isfinite(s_)]
            else:
                dres = self.dense.search(q, k=kk)
                dense_ids = [int(i) for i in dres.ids[0] if i >= 0]
            lex_scores = {}
            if lexical_ok:
                ls, li = self.lexical.search(query, k=ck)
                lex_scores = {int(i): float(s)
                              for s, i in zip(ls, li) if i >= 0}

        cand = sorted(set(dense_ids) | set(lex_scores))
        if not cand:
            return []

        # Fuse the union in one call (ops/hybrid.fuse_candidates); the
        # candidate count is padded to a power of two, as the JAX package
        # pads it.
        from optimized_rag_tpu_torch.ops.hybrid import fuse_candidates
        c_pad = 1 << (max(len(cand), top_k, 8) - 1).bit_length()
        cand_ids = np.full(c_pad, -1, np.int32)
        cand_ids[:len(cand)] = cand
        cand_valid = cand_ids >= 0
        kw = np.zeros(c_pad, np.float32)
        kw[:len(cand)] = [lex_scores.get(c, 0.0) for c in cand]
        ages = np.zeros(c_pad, np.float32)
        if self.get_created_at is not None:
            now = time.time()
            ages[:len(cand)] = [(now - self.get_created_at(c)) / 86400.0
                                for c in cand]
        qn = np.asarray(q[0], np.float32)
        qn = qn / max(np.linalg.norm(qn), 1e-9)
        packed = fuse_candidates(
            qn, self.dense.embeddings(), cand_ids, cand_valid, kw, ages,
            self._weights(weights), self.half_life_days,
            k=min(top_k, c_pad),
            row_scale=self.dense.row_scale).cpu().numpy()
        fused, pos = packed[0], packed[1].astype(np.int64)
        out = []
        for col, (s, p) in enumerate(zip(fused, pos)):
            if p < 0 or p >= len(cand):
                continue
            out.append(self._mk(cand[int(p)], float(s),
                                semantic=float(packed[2, col]),
                                keyword=float(packed[3, col]),
                                temporal=float(packed[4, col])))
        return out

    # ------------------------------------------------------------- helpers

    def _mk(self, doc_id: int, score: float, semantic=0.0, keyword=0.0,
            temporal=0.0) -> RetrievedDoc:
        return RetrievedDoc(
            doc_id=doc_id, score=score, text=self.get_text(doc_id),
            source=self.source,
            created_at=(self.get_created_at(doc_id)
                        if self.get_created_at else time.time()),
            semantic_score=semantic, keyword_score=keyword,
            temporal_score=temporal)
