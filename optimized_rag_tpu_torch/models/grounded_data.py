"""Label-free grounded-QA synthesis for the pointer-generator.

Held against ``optimized_rag_tpu/models/grounded_data.py`` (:1-271), of
which it is a copy: from the same ``np.random.Generator`` state,
``GroundedSampler.batch`` gives the JAX package's rows, ``pad_len`` and
``copy_tgt`` exactly.

Training pairs are synthesized from any text corpus with zero labels:

  context docs (gold chunk + distractors, random [N] position)
  + a question derived from one sentence of the gold chunk
  -> that sentence (optionally clause-rotated / marker-stripped for
     word-order novelty) + its correct " [N]" citation

plus explicit REFUSAL rows (the gold chunk is absent from the context) so
the model learns the insufficient-context behavior the agent's
verification stack expects. Because the synthesis knows exactly which
prompt bytes the target copies, it emits byte-level copy alignments
(``copy_tgt``) that directly supervise the pointer attention
(models/grounded.GroundedTrainer).

Questions are heuristic transforms (wh-template + ordered content-word
subset of the answer sentence), not the fixture QA sheets, so the QA
evaluation stays held out.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import numpy as np

from optimized_rag_tpu_torch.models.decoder import EOS, PAD, encode_bytes
from optimized_rag_tpu_torch.models.grounded import (
    REFUSAL, _content_words, render_candidates, select_candidates)

_WH = ("What is", "What are", "What does", "How does", "How is", "Why is",
       "Why does", "Which", "When does", "What", "How")
_MARKERS = re.compile(
    r"^(However|Moreover|In addition|Also|Furthermore|Note that|"
    r"For example|In practice|In general|By default|Additionally|"
    r"Similarly|Finally),?\s+(.+)$")
_CLAUSE = re.compile(
    r"^(If|When|Because|Since|Although|While|Unless)\s+([^,]{4,90}),\s+"
    r"(.+?)([.!?])$")
_SRC_CIT = re.compile(r"\s*\[\d+\]")
_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def split_sentences(text: str) -> List[str]:
    return [s.strip() for s in _SENT_SPLIT.split(" ".join(text.split()))
            if s.strip()]


def _transform(rng: np.random.Generator, sent: str) -> str:
    """Deterministic abstraction transforms: the model learns that
    grounded answers may REORDER the evidence, not only copy it."""
    s = _SRC_CIT.sub("", sent).strip()
    m = _MARKERS.match(s)
    if m and rng.random() < 0.8:
        s = m.group(2)
        s = s[0].upper() + s[1:]
    m = _CLAUSE.match(s)
    if m and rng.random() < 0.5:
        lead, clause, main, punct = m.groups()
        s = main[0].upper() + main[1:] + " " + lead.lower() + " " \
            + clause.strip() + punct
    return s


def make_question(rng: np.random.Generator, sent: str) -> Optional[str]:
    """Wh-question from an ordered content-word subset of the sentence —
    lexically matched to the answer the way natural questions are, with
    the exact answer phrasing not given away."""
    content = _content_words(sent)
    if len(content) < 3:
        return None
    hi = min(len(content), 6)
    # >=3 kept words: 2-word questions are frequently satisfied by more
    # than one sentence, and the unique gold label then teaches WRONG
    # selection (label noise exactly on the byte the early-position
    # loss weighting emphasizes).
    n_keep = int(rng.integers(3, hi + 1))
    idx = sorted(rng.choice(len(content), size=n_keep, replace=False))
    kept = " ".join(content[i] for i in idx)
    q = f"{_WH[int(rng.integers(0, len(_WH)))]} {kept}?"
    if rng.random() < 0.3:
        q = q.lower()
    return q


class GroundedSampler:
    """Streams (ids, pad_len, copy_tgt) training batches.

    ``texts`` are corpus chunks; each is pre-split into sentences once.
    Docs rendered into a prompt are CONSECUTIVE-sentence windows capped
    at ``doc_bytes`` so the gold sentence always survives rendering
    (serving-side compression works at the same per-doc scale).
    """

    def __init__(self, texts: Sequence[str], prompt_len: int = 2560,
                 target_len: int = 320, doc_bytes: int = 420,
                 refusal_frac: float = 0.2, two_sent_frac: float = 0.2,
                 m: int = 4, max_sent_bytes: int = 360):
        self.P = prompt_len
        self.T = target_len
        self.doc_bytes = doc_bytes
        self.refusal_frac = refusal_frac
        self.two_sent_frac = two_sent_frac
        self.m = m
        self.max_sent_bytes = max_sent_bytes
        self.sents: List[List[str]] = []
        for t in texts:
            ss = [s for s in split_sentences(t)
                  if 24 <= len(s.encode("utf-8")) <= 360]
            if ss:
                self.sents.append(ss)
        if len(self.sents) < 8:
            raise ValueError("corpus too small for grounded synthesis")

    # -- doc windows ---------------------------------------------------------

    def _window(self, rng, ci: int, must_include: int = -1) -> str:
        """Consecutive-sentence window of chunk ``ci`` within doc_bytes,
        containing sentence ``must_include`` when given."""
        ss = self.sents[ci]
        j = must_include if must_include >= 0 \
            else int(rng.integers(0, len(ss)))
        lo = hi = j
        used = len(ss[j].encode("utf-8"))
        order = []
        while True:
            grew = False
            if lo > 0 and rng.random() < 0.7:
                b = len(ss[lo - 1].encode("utf-8")) + 1
                if used + b <= self.doc_bytes:
                    lo -= 1
                    used += b
                    grew = True
            if hi + 1 < len(ss):
                b = len(ss[hi + 1].encode("utf-8")) + 1
                if used + b <= self.doc_bytes:
                    hi += 1
                    used += b
                    grew = True
            if not grew:
                break
        del order
        return " ".join(ss[lo:hi + 1])

    # -- one example ---------------------------------------------------------

    def sample(self, rng: np.random.Generator):
        """Returns (prompt_str, answer_str, core_str or None).

        Candidate-mode synthesis (round 5): the docs are rendered into a
        CANDIDATE-SENTENCE prompt through the same ``select_candidates``
        the serving provider uses, so training matches the serving
        distribution by construction. ``core_str`` is the verbatim-copied
        span (None when transformed or refusal) used for copy-alignment
        supervision.
        """
        n_docs = int(rng.integers(3, 7))
        gold_ci = int(rng.integers(0, len(self.sents)))
        gold_sents = self.sents[gold_ci]
        j = int(rng.integers(0, len(gold_sents)))
        question = make_question(rng, gold_sents[j])
        if question is None:
            return self.sample(rng)

        refusal = rng.random() < self.refusal_frac
        docs = []
        pool = rng.choice(len(self.sents), size=n_docs + 2, replace=False)
        pool = [int(p) for p in pool if p != gold_ci][:n_docs]
        for ci in pool:
            docs.append(self._window(rng, ci))
        budget = self.P - 32

        if refusal:
            docs = docs[:n_docs]
            cands = select_candidates(question, docs, m=self.m,
                                      max_sent_bytes=self.max_sent_bytes)
            if not cands:
                # serving refuses WITHOUT a model call when no sentence
                # overlaps the question — such rows teach nothing.
                return self.sample(rng)
            prompt = render_candidates(cands, question, max_bytes=budget)
            return prompt, REFUSAL, None

        k = int(rng.integers(0, n_docs))
        gold_doc = self._window(rng, gold_ci, must_include=j)
        docs = docs[: n_docs - 1]
        docs.insert(k, gold_doc)
        gold_norm = _SRC_CIT.sub("", " ".join(gold_sents[j].split())).strip()
        cands = select_candidates(question, docs, m=self.m,
                                  max_sent_bytes=self.max_sent_bytes)
        if (k, gold_norm) not in cands:
            # question terms come from the gold sentence, so it scores
            # near the top; the rare miss (duplicate elsewhere, stemming
            # quirk) is force-inserted to keep the label correct.
            cands = cands[: self.m - 1] + [(k, gold_norm)]
        # Fit the byte budget dropping lowest-relevance non-gold first.
        while len(cands) > 1 and len(render_candidates(
                cands, question, max_bytes=1 << 30).encode("utf-8")) > budget:
            drop = max((i for i in range(len(cands))
                        if cands[i] != (k, gold_norm)), default=None)
            if drop is None:
                break
            cands.pop(drop)
        # Presentation order must carry NO label signal.
        order = rng.permutation(len(cands))
        cands = [cands[int(i)] for i in order]
        prompt = render_candidates(cands, question, max_bytes=budget)
        if f"] {gold_norm}\n" not in prompt:
            return self.sample(rng)

        two = (rng.random() < self.two_sent_frac
               and j + 1 < len(gold_sents)
               and (k, _SRC_CIT.sub("", " ".join(
                   gold_sents[j + 1].split())).strip()) in cands)
        core = gold_norm
        ans = _transform(rng, gold_norm)
        parts = [f"{ans} [{k + 1}]"]
        if two:
            nxt = _SRC_CIT.sub("", " ".join(gold_sents[j + 1].split()))
            parts.append(f"{_transform(rng, nxt.strip())} [{k + 1}]")
        answer = " ".join(parts)
        if len(answer.encode("utf-8")) > self.T - 16:
            answer = parts[0]
        core_out = core if ans == core else None
        return prompt, answer, core_out

    # -- batch collation -----------------------------------------------------

    def batch(self, rng: np.random.Generator, b: int):
        """(ids [B, P+T] i32, pad_len [B] i32, copy_tgt [B, T] i32)."""
        P, T = self.P, self.T
        ids = np.full((b, P + T), PAD, np.int32)
        pad_len = np.zeros(b, np.int32)
        copy_tgt = np.full((b, T), -1, np.int32)
        for r in range(b):
            prompt, answer, core = self.sample(rng)
            prow = encode_bytes(prompt, P, truncate="left")
            pad = P - len(prow)
            ids[r, pad:P] = prow
            pad_len[r] = pad
            tgt = (" " + answer).encode("utf-8")[: T - 1]
            trow = [bb + 3 for bb in tgt] + [EOS]
            ids[r, P:P + len(trow)] = trow
            if core is not None:
                pb = prompt.encode("utf-8")
                cb = core.encode("utf-8")
                src = pb.find(cb)
                # answer layout: " " + core + " [k]..." -> target byte
                # t maps to source byte src + (t - 1) for t in the core
                # span (BOS sits at prompt position ``pad``).
                if src >= 0:
                    # prompt row may be tail-trimmed by encode_bytes:
                    # prompt position of source byte i = pad + 1 + i
                    # only valid when the whole core survived the trim.
                    trim = max(len(pb) - (P - 1 - pad), 0)
                    if src >= trim:
                        base = pad + 1 + (src - trim)
                        for t in range(1, min(1 + len(cb), T)):
                            sp = base + (t - 1)
                            # Supervise only where BOTH ends hold the
                            # core byte: the prompt may be tail-trimmed
                            # and the target right-truncated.
                            if (ids[r, sp] == (cb[t - 1] + 3)
                                    and ids[r, P + t] == (cb[t - 1] + 3)):
                                copy_tgt[r, t] = sp
        return ids, pad_len, copy_tgt
