"""Cross-document contradiction detection.

Re-implements rag/consistency_checker.py:15-280: the O(n^2) per-pair
Python cosine loop (:169-190) becomes ONE batched pairwise similarity
matrix (ops/similarity.pairwise_cosine); pairs above the similarity
threshold (0.85) then run the reference's negation/number heuristics
(:193-239). Confidence penalty: 15% per contradiction, floor 0.5
(applied by the caller, reference rag/nodes/rerank_and_eval.py:176-186).

Held against ``optimized_rag_tpu/engine/consistency.py``: the pairwise
cosine runs on the checker's ``device`` in full float32 (TF32 stays off,
as the reference pins ``Precision.HIGHEST``), then one copy to the host.
"""

from __future__ import annotations

import re
from typing import Callable, List

import numpy as np
import torch

from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.engine.types import RetrievedDoc
from optimized_rag_tpu_torch.ops.similarity import pairwise_cosine

_NEGATION_PAIRS = (
    ("is not", "is"), ("are not", "are"), ("was not", "was"),
    ("were not", "were"), ("does not", "does"), ("do not", "do"),
    ("did not", "did"), ("cannot", "can"), ("will not", "will"),
    ("should not", "should"), ("no", "yes"), ("false", "true"),
    ("incorrect", "correct"), ("never", "always"),
)
_NUM_RE = re.compile(r"\b\d+\.?\d*\b")


def is_contradiction(text1: str, text2: str) -> bool:
    """Negation/number heuristics (reference :193-239)."""
    t1, t2 = text1.lower(), text2.lower()
    for neg, pos in _NEGATION_PAIRS:
        if (neg in t1 and pos in t2 and neg not in t2) or \
           (neg in t2 and pos in t1 and neg not in t1):
            return True
    n1, n2 = set(_NUM_RE.findall(text1)), set(_NUM_RE.findall(text2))
    if n1 and n2 and n1 != n2:
        return True
    return False


class ConsistencyChecker:
    def __init__(self, embed_fn: Callable[[List[str]], np.ndarray],
                 sim_threshold: float = 0.85,
                 contradiction_penalty: float = 0.15,
                 min_confidence: float = 0.5, device="cuda"):
        self.device = resolve_device(device)
        self.embed_fn = embed_fn
        self.sim_threshold = sim_threshold
        self.penalty = contradiction_penalty
        self.min_confidence = min_confidence

    def check_consistency(self, docs: List[RetrievedDoc],
                          sim: "np.ndarray | None" = None) -> dict:
        """Returns {consistent, contradictions: [(i, j, sim)], confidence_penalty}.

        ``sim`` optionally supplies the precomputed pairwise-cosine matrix
        (e.g. from the fused rerank/eval dispatch, ops/fused_eval.py) so no
        extra device round trip is spent here.
        """
        if len(docs) < 2:
            return {"consistent": True, "contradictions": [],
                    "confidence_multiplier": 1.0}
        texts = [d.text for d in docs]
        if sim is None:
            emb = self.embed_fn(texts)
            sim = pairwise_cosine(torch.as_tensor(
                np.asarray(emb, np.float32), device=self.device)).cpu().numpy()
        else:
            sim = np.asarray(sim)
            if sim.shape != (len(docs), len(docs)):
                # Hard error (not assert: must survive python -O) — a
                # mis-aligned matrix would yield silently wrong
                # contradiction indices (ADVICE r2).
                raise ValueError(
                    f"sim matrix shape {sim.shape} != ({len(docs)},"
                    f" {len(docs)}); pass the matrix for exactly these docs")
        # Only pairs with high topical similarity can "contradict".
        cand = np.argwhere(np.triu(sim, k=1) >= self.sim_threshold)
        contradictions = []
        for i, j in cand:
            if is_contradiction(texts[i], texts[j]):
                contradictions.append((int(i), int(j), float(sim[i, j])))
        multiplier = max(self.min_confidence,
                         1.0 - self.penalty * len(contradictions))
        return {"consistent": not contradictions,
                "contradictions": contradictions,
                "confidence_multiplier": multiplier}
