"""Grounded pointer-generator: the on-device RAG answer generator, its
serving half.

Held against ``optimized_rag_tpu/models/grounded.py`` (:49-393,
:522-595): a byte-level decoder backbone (``models/decoder.DecoderLM``)
with a COPY mechanism over the prompt, the pointer-generator mixture

    p(v) = p_gen * softmax(lm_logits)[v]
         + (1 - p_gen) * sum_{p: prompt[p]=v} copy_attn[p]

The copy attention runs in float32 between the backbone's final hidden
states at the decode position and at the PROMPT positions; the prompt's
copy keys and its one-hot [B, P, V] are computed once, at prefill. Serving
renders the agent's generation prompt into the model's compact native
format (``render_candidates``) and decodes greedily (``models/decoder``'s
prefill and KV-cached loop). ``GroundedTrainer`` (the reference's
:395-520) trains it on rows of ``models/grounded_data.GroundedSampler``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.models.decoder import (
    MASKED, PAD, DecoderConfig, DecoderLM, Dense, cache_buffers,
    decode_loop, gumbel_pick, left_pad, prefill_masks, texts_of)
from optimized_rag_tpu_torch.models.encoder import serving_module
from optimized_rag_tpu_torch.models.training import Trainer


@dataclasses.dataclass(frozen=True)
class GroundedConfig(DecoderConfig):
    """Decoder backbone + pointer-head dims. ``copy_dim`` is the copy
    attention's query/key width; its presence in a checkpoint config marks
    the grounded family (models/pretrain.load_pretrained).
    ``prompt_len``/``target_len`` record the lengths the checkpoint was
    TRAINED at, so serving renders prompts into the same regime."""
    copy_dim: int = 128
    max_seq_len: int = 3072
    prompt_len: int = 2560
    target_len: int = 320


class CopyHeads(nn.Module):
    """Pointer heads over backbone hidden states [B, L, H] (float32): copy
    query/key projections and the generation-gate logit."""

    def __init__(self, hidden_dim: int, copy_dim: int):
        super().__init__()
        self.copy_q = Dense(hidden_dim, copy_dim)
        self.copy_k = Dense(hidden_dim, copy_dim)
        self.p_gen = Dense(hidden_dim, 1)

    def forward(self, h):
        return self.copy_q(h), self.copy_k(h), self.p_gen(h)[..., 0]


def copy_attention(q, k_prompt, prompt_valid):
    """Copy attention [B, T, P]: q [B, T, Hc] against k_prompt [B, P, Hc],
    invalid prompt positions (left padding) masked out; float32."""
    scale = float(np.float32(1.0 / np.sqrt(q.shape[-1])))
    att = torch.einsum("bth,bph->btp", q.float(), k_prompt.float()) * scale
    return torch.softmax(torch.where(prompt_valid[:, None, :], att, MASKED),
                         dim=-1)


def mixed_log_probs(lm_logits, copy_attn, prompt_onehot, p_gen_logit):
    """Pointer-generator mixture in probability space -> log probs.

    lm_logits [B, T, V]; copy_attn [B, T, P]; prompt_onehot [B, P, V];
    p_gen_logit [B, T]. Returns log p [B, T, V].
    """
    copy_v = torch.einsum("btp,bpv->btv", copy_attn, prompt_onehot)
    pg = torch.sigmoid(p_gen_logit)[..., None]
    probs = pg * torch.softmax(lm_logits.float(), dim=-1) \
        + (1.0 - pg) * copy_v
    return torch.log(probs + 1e-9)


# ---------------------------------------------------------------------------
# Prompt rendering (byte-exact with the reference)
# ---------------------------------------------------------------------------

PROMPT_HEAD = "context:\n"
PROMPT_Q = "question: "
PROMPT_A = "\nanswer:"
REFUSAL = ("I don't have enough information in the provided context "
           "to answer that.")

_STOP = frozenset(
    "the a an is are was were of to and in on by for with that this its as "
    "at or it do does did what which who when where why how have has had "
    "can could would should be been".split())
_WORD = re.compile(r"[a-z0-9]+")
_SRC_CIT_G = re.compile(r"\s*\[\d+\]")


def _content_words(text: str) -> List[str]:
    return [w for w in _WORD.findall(text.lower())
            if w not in _STOP and len(w) > 2]


def compress_doc(doc: str, question: str, budget: int) -> str:
    """Trim one doc to ``budget`` BYTES by dropping the least
    question-relevant sentences (original order kept)."""
    if len(doc.encode("utf-8")) <= budget:
        return doc
    from optimized_rag_tpu_torch.agent.verification import split_sentences
    sents = split_sentences(doc)
    if not sents:
        return doc.encode("utf-8")[:budget].decode("utf-8", "ignore")
    q_terms = set(_content_words(question))
    scored = sorted(
        range(len(sents)),
        key=lambda i: -len(q_terms & set(_content_words(sents[i]))))
    keep, used = set(), 0
    for i in scored:
        b = len(sents[i].encode("utf-8")) + 1
        if used + b > budget:
            continue
        keep.add(i)
        used += b
    if not keep:                      # all sentences over budget: hard cut
        return doc.encode("utf-8")[:budget].decode("utf-8", "ignore")
    return " ".join(sents[i] for i in sorted(keep))


def render_prompt(docs: Sequence[str], question: str,
                  max_bytes: int = 2500) -> str:
    """Compact native prompt:  context:\\n[1] d1\\n[2] d2...\\nquestion:
    q\\nanswer:   Docs over budget are compressed per-doc (relevance-kept
    sentences); the [N] numbering matches the agent's source list so
    emitted citations resolve."""
    docs = [" ".join(d.split()) for d in docs]
    q = " ".join(question.split())
    fixed = (len(PROMPT_HEAD) + len(PROMPT_Q) + len(PROMPT_A)
             + len(q.encode("utf-8")) + sum(len(f"[{i+1}] \n")
                                            for i in range(len(docs))))
    doc_budget = max(120, (max_bytes - fixed) // max(len(docs), 1))
    parts = [PROMPT_HEAD]
    for i, d in enumerate(docs):
        parts.append(f"[{i+1}] {compress_doc(d, q, doc_budget)}\n")
    parts.append(PROMPT_Q + q + PROMPT_A)
    return "".join(parts)


def _truncate_utf8(text: str, max_bytes: int) -> str:
    """Hard byte cap at a word boundary (never splits a codepoint)."""
    b = text.encode("utf-8")
    if len(b) <= max_bytes:
        return text
    cut = b[:max_bytes].decode("utf-8", "ignore")
    sp = cut.rfind(" ")
    return (cut[:sp] if sp > max_bytes // 2 else cut).strip()


def select_candidates(question: str, docs: Sequence[str], m: int = 4,
                      max_sent_bytes: int = 360):
    """Top-``m`` answer-candidate sentences across the numbered docs.

    Returns ``[(doc_idx, sentence)]`` in DESCENDING relevance order
    (stemmed content-word overlap + doubled bigram hits, length-normalized
    like agent/llm.DeterministicLLM's extractive scorer; exact-duplicate
    sentences dropped; inline source citation markers removed). An empty
    return means no sentence shares any content word with the question —
    the caller refuses."""
    from optimized_rag_tpu_torch.agent.llm import DeterministicLLM
    from optimized_rag_tpu_torch.agent.verification import split_sentences
    stem = DeterministicLLM._stem
    q_raw = _WORD.findall(question.lower())
    q_terms = [stem(w) for w in q_raw if w not in _STOP and len(w) > 2]
    q_set = set(q_terms)
    q_bi = set(zip(q_terms, q_terms[1:]))
    if not q_set:
        return []
    scored = []
    seen = set()
    for i, doc in enumerate(docs):
        for s in split_sentences(" ".join(doc.split())):
            s = _SRC_CIT_G.sub("", s).strip()
            if len(s) < 12:
                continue
            sw = [stem(w) for w in _WORD.findall(s.lower())]
            key = tuple(sw)
            if not sw or key in seen:
                continue
            seen.add(key)
            hits = q_set & set(sw)
            if not hits:
                continue
            bi = q_bi & set(zip(sw, sw[1:]))
            ln = max(1.0, math.sqrt(len(sw) / 30.0))
            score = (len(hits) + 2.0 * len(bi)) / ln
            scored.append((score, i, _truncate_utf8(s, max_sent_bytes)))
    scored.sort(key=lambda t: (-t[0], t[1], t[2]))
    return [(i, s) for _, i, s in scored[:m]]


def render_candidates(cands, question: str, max_bytes: int = 1700) -> str:
    """Render candidate sentences as  context:\\n[n] s...\\nquestion: q\\n
    answer:  — ``n`` is each candidate's TRUE source-doc number (1-based,
    may repeat). Drops candidates from the END of the list to fit
    ``max_bytes`` (callers pass relevance-ordered lists)."""
    q = _truncate_utf8(" ".join(question.split()), 256)
    kept = list(cands)
    while True:
        parts = [PROMPT_HEAD]
        parts += [f"[{i + 1}] {s}\n" for i, s in kept]
        parts.append(PROMPT_Q + q + PROMPT_A)
        txt = "".join(parts)
        if len(txt.encode("utf-8")) <= max_bytes or not kept:
            return txt
        kept.pop()


# ---------------------------------------------------------------------------
# Generator (prefill + KV-cached decode with the pointer mixture)
# ---------------------------------------------------------------------------

class _Grounded(nn.Module):
    """The backbone and the pointer heads (float32 in either form)."""

    def __init__(self, cfg: GroundedConfig, param_dtype=None):
        super().__init__()
        self.backbone = DecoderLM(cfg, param_dtype)
        self.heads = CopyHeads(cfg.hidden_dim, cfg.copy_dim)


class GroundedGenerator:
    """Batched greedy/sampled generation with the pointer mixture on
    ``device``.

    ``params`` is a state dict of ``backbone.*`` (a DecoderLM's) and
    ``heads.*`` (CopyHeads') keys (``models/convert.
    grounded_flax_to_torch``); without it the weights are random from
    ``seed``. Prefill computes the prompt's copy keys once; every decode
    step reuses them (keys of generated tokens are never copy sources:
    answers must be grounded in the PROMPT).
    """

    def __init__(self, cfg: Optional[GroundedConfig] = None, params=None,
                 seed: int = 0, max_prompt_len: int = 2560,
                 max_new_tokens: int = 320, device="cuda"):
        self.cfg = cfg or GroundedConfig()
        if max_prompt_len + max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(f"{max_prompt_len} + {max_new_tokens} > "
                             f"max_seq_len {self.cfg.max_seq_len}")
        self.device = resolve_device(device)
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        self.model = serving_module(lambda: _Grounded(self.cfg), params, seed,
                                    self.device)

    @torch.inference_mode()
    def _generate(self, ids, pad_len, temperature: float, seed: int,
                  max_new: int) -> torch.Tensor:
        """LEFT-padded ids [B, P] and pad counts [B] -> [max_new, B]."""
        backbone, heads = self.model.backbone, self.model.heads
        p = ids.shape[1]
        if p + max_new > self.cfg.max_seq_len:
            raise ValueError(f"{p} + {max_new} > max_seq_len "
                             f"{self.cfg.max_seq_len}")
        pad_mask, pos_ids, storage_valid = prefill_masks(pad_len, p, max_new)
        logits, caches, h = backbone(ids, key_valid=pad_mask,
                                     pos_ids=pos_ids)
        qc, kc, pg = heads(h)
        prompt_onehot = F.one_hot(ids, self.cfg.vocab_size).float()
        caches = cache_buffers(caches, p + max_new)

        def mix_last(lm_logit, q_last, pg_last):
            """One decode position's mixed log-probs [B, V]."""
            att = copy_attention(q_last[:, None], kc, pad_mask)   # [B,1,P]
            return mixed_log_probs(lm_logit[:, None], att, prompt_onehot,
                                   pg_last[:, None])[:, 0]

        def step(toks, t):
            pos = p + t
            nl, _, h1 = backbone(toks[:, None], caches, pos, storage_valid,
                                 (pos - pad_len)[:, None])
            return mix_last(nl[:, 0], heads.copy_q(h1[:, 0]),
                            heads.p_gen(h1[:, 0])[:, 0])

        if temperature <= 1e-4:
            pick = lambda lp: torch.argmax(lp, dim=-1)  # noqa: E731
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            pick = lambda lp: gumbel_pick(  # noqa: E731
                lp / max(temperature, 1e-4), gen)
        return decode_loop(mix_last(logits[:, -1], qc[:, -1], pg[:, -1]),
                           step, pick, max_new)

    def generate_batch(self, prompts: List[str],
                       max_new_tokens: Optional[int] = None,
                       temperature: float = 0.0,
                       seed: int = 0) -> List[str]:
        ids, pad_len = left_pad(prompts, self.max_prompt_len)
        return texts_of(self._generate(
            torch.from_numpy(ids).to(self.device),
            torch.from_numpy(pad_len).to(self.device), temperature, seed,
            max_new_tokens or self.max_new_tokens))

    def generate(self, prompt: str, **kw) -> str:
        return self.generate_batch([prompt], **kw)[0]


# ---------------------------------------------------------------------------
# Trainer (teacher-forced mixture NLL + copy-alignment auxiliary)
# ---------------------------------------------------------------------------

class GroundedTrainer(Trainer):
    """Trains the pointer-generator on synthesized grounded-QA rows on the
    mesh's data devices (``models/training.Trainer``).

    Row layout (fixed split, static shapes): positions [0, P) hold the
    LEFT-padded prompt (BOS + rendered context+question+"answer:");
    positions [P, P+T) hold the target answer bytes + EOS, PAD-padded on
    the right. ``copy_tgt`` [B, T] marks the known source position in
    [0, P) each target byte was copied from (-1 = unsupervised), giving the
    copy attention a direct cross-entropy signal. The loss is the mixture
    NLL plus ``copy_loss_weight`` times that auxiliary, the first
    ``early_len`` target positions weighted by ``early_weight`` in both
    (the sentence-selection decision lives there); the gradients are
    clipped to a global norm of 1 before AdamW, as optax chains them.
    ``train_step`` returns (nll, copy loss); ``last_grad_norm`` holds the
    norm before clipping.
    """

    def __init__(self, cfg: GroundedConfig, mesh, prompt_len: int = 2560,
                 target_len: int = 320, learning_rate=3e-4, seed: int = 0,
                 copy_loss_weight: float = 0.3,
                 early_weight: float = 8.0, early_len: int = 6):
        if prompt_len + target_len > cfg.max_seq_len:
            raise ValueError(f"{prompt_len} + {target_len} > max_seq_len "
                             f"{cfg.max_seq_len}")
        self.cfg = cfg
        self.P, self.T = prompt_len, target_len
        self._copy_w = copy_loss_weight
        self._early_w, self._early_len = early_weight, early_len
        super().__init__(lambda: _Grounded(cfg, torch.float32), mesh,
                         learning_rate, seed, clip_norm=1.0)

    def _rows(self, model, ids, pad_len, copy_tgt):
        """Per-row log-probs of each target byte under the mixture, and of
        its known copy source under the copy attention: [b, T] each."""
        P, T = self.P, self.T
        ids = ids.long()
        col = torch.arange(ids.shape[1], device=ids.device)[None]
        key_valid = col >= pad_len[:, None]
        pos_ids = torch.clamp_min(col - pad_len[:, None], 0)
        logits, _, h = model.backbone(ids, key_valid=key_valid,
                                      pos_ids=pos_ids)
        qc, kc, pg = model.heads(h)
        labels = ids[:, P:]                                   # [B, T]
        att = copy_attention(qc[:, P - 1:P + T - 1], kc[:, :P],
                             key_valid[:, :P])                # [B, T, P]
        onehot = F.one_hot(ids[:, :P], self.cfg.vocab_size).float()
        logp = mixed_log_probs(logits[:, P - 1:P + T - 1], att, onehot,
                               pg[:, P - 1:P + T - 1])        # [B, T, V]
        tgt_lp = torch.gather(logp, -1, labels[..., None])[..., 0]
        safe = torch.clamp_min(copy_tgt.long(), 0)
        att_lp = torch.log(torch.gather(att, -1, safe[..., None])[..., 0]
                           + 1e-9)
        return tgt_lp, att_lp

    def _loss(self, rows, ids, copy_tgt):
        tgt_lp, att_lp = rows
        labels = ids[:, self.P:]
        mask = (labels != PAD).float()
        tpos = torch.arange(self.T, device=ids.device)[None]
        pw = torch.where(tpos < self._early_len, self._early_w, 1.0)
        wm = mask * pw
        nll = -(tgt_lp * wm).sum() / torch.clamp_min(wm.sum(), 1.0)
        cwm = ((copy_tgt >= 0) & (labels != PAD)).float() * pw
        closs = -(att_lp * cwm).sum() / torch.clamp_min(cwm.sum(), 1.0)
        return nll + self._copy_w * closs, (nll.detach(), closs.detach())

    def _batch(self, ids, pad_len, copy_tgt):
        return (ids, pad_len, copy_tgt), (ids, copy_tgt)

    def _result(self, loss, aux):
        return float(aux[0]), float(aux[1])       # (nll, copy loss)


# ---------------------------------------------------------------------------
# LLM-provider adapter
# ---------------------------------------------------------------------------

class GroundedProvider:
    """LLMProvider whose ``generate`` task runs the trained
    pointer-generator on the device; every other task keeps the
    deterministic offline defaults. There is NO extractive fallback on the
    generate task: an empty or degenerate generation becomes an explicit
    refusal, so answers measure the MODEL, not a fallback.
    """

    def __init__(self, generator: GroundedGenerator, fallback=None,
                 temperature: float = 0.0):
        from optimized_rag_tpu_torch.agent.llm import DeterministicLLM
        self.generator = generator
        self.fallback = fallback or DeterministicLLM()
        self.temperature = temperature

    def _native_prompt(self, prompt: str) -> Optional[str]:
        """Candidate-sentence prompt (see select_candidates): the
        pipeline's lexical scorer shortlists sentences; the MODEL does the
        final selection, rewrite and citation. Returns None (an explicit
        refusal, no model call) when no sentence shares a content word
        with the question, or when the best candidate fails the
        minimum-evidence bar (the reference's context-quality gate, which
        also refuses before its generation call)."""
        from optimized_rag_tpu_torch.agent.llm import DeterministicLLM
        docs = DeterministicLLM._context_docs(prompt)
        query = DeterministicLLM._query_of(prompt)
        cands = select_candidates(query, docs, m=4)
        if not cands:
            return None
        stem = DeterministicLLM._stem
        q_terms = [stem(w) for w in _WORD.findall(query.lower())
                   if w not in _STOP and len(w) > 2]
        q_set = set(q_terms)
        q_bi = set(zip(q_terms, q_terms[1:]))

        def raw_hits(s: str) -> float:
            sw = [stem(w) for w in _WORD.findall(s.lower())]
            return (len(q_set & set(sw))
                    + 2.0 * len(q_bi & set(zip(sw, sw[1:]))))

        if len(q_set) >= 3 and max(raw_hits(s) for _, s in cands) < 2.0:
            return None
        max_b = self.generator.max_prompt_len - 32
        return render_candidates(cands, query, max_bytes=max_b)

    def _generate(self, prompt: str, **kw) -> str:
        native = self._native_prompt(prompt)
        if native is None:
            return REFUSAL
        out = self.generator.generate(
            native,
            temperature=kw.get("temperature", self.temperature)).strip()
        return out if out else REFUSAL

    def complete(self, prompt: str, task: str = "", **kw) -> str:
        if task == "generate":
            return self._generate(prompt, **kw)
        return self.fallback.complete(prompt, task=task, **kw)

    def structured(self, prompt: str, keys, task: str = "", **kw) -> Dict:
        if task == "generate":
            out = self._generate(prompt, **kw)
            return {"answer": out,
                    "citations": sorted({int(m) for m in
                                         re.findall(r"\[(\d+)\]", out)})}
        return self.fallback.structured(prompt, keys, task=task, **kw)
