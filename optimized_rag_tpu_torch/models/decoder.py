"""Decoder-only byte-level language model with KV-cached generation.

Held against ``optimized_rag_tpu/models/decoder.py`` (:34-356). The
numerics follow the Flax modules:

* token and position embeddings, ``qkv``, ``attn_out`` and the MLP compute
  in ``cfg.dtype`` (bfloat16 for the checkpoints; weights stored as float16
  are rounded to it); LayerNorm runs in float32 (Flax's fast variance, eps
  1e-6) and its output is cast to ``cfg.dtype``; the ``head`` runs in
  float32 over ``ln_f``'s float32 output;
* attention: the score einsum in ``cfg.dtype``, then float32 times
  1/sqrt(head_dim) (the reference's numpy scale promotes the scores to
  float32), the mask and softmax in float32, the weights cast back to
  ``cfg.dtype`` for the einsum with v; written as two einsums, as the
  reference leaves attention to XLA;
* GELU is the tanh approximation written op by op, and a Dense layer is
  the product, then the bias: XLA rounds a bfloat16 result after every op,
  and so does torch op by op (``F.gelu`` rounds once, which differs from
  the reference's GELU in 40% of bfloat16 outputs and moved the
  checkpoint's logits by up to 0.9).

``DecoderLM`` takes ``param_dtype`` as the encoders do
(``models/encoder.py``): the serving form stores its weights in
``cfg.dtype``, the training form (``torch.float32``) keeps float32 master
weights cast to the compute dtype at each use.

Generation runs one prefill over LEFT-padded prompts (pad keys masked,
per-row positional ids), then a KV-cached decode loop in which every row
writes the cache at one scalar position; finished rows emit PAD. The
reference runs a fixed ``lax.scan`` of ``max_new`` steps; the loop here
stops once every row has finished, which gives the same tokens.

Sampling (``temperature > 1e-4``) draws from a ``torch.Generator`` seeded
from ``seed``; ``jax.random``'s stream cannot be matched, so sampled text
differs from the reference's. Each step draws one Gumbel vector that every
row shares, so a row's sample does not depend on the batch it rides in.
Greedy decoding (the default) is deterministic and matches the reference.

``LocalLMProvider`` adapts the model to the agent's LLMProvider interface.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.models.encoder import (
    _LayerNorm, embed, serving_module)

PAD = 0
BOS = 1
EOS = 2
NUM_SPECIAL = 3
BYTE_OFFSET = NUM_SPECIAL          # byte b -> id b + 3
MASKED = -1e30                     # the reference's mask value


def encode_bytes(text: str, max_len: Optional[int] = None,
                 truncate: str = "right") -> np.ndarray:
    """Byte-level encode with BOS. ``truncate``: "right" drops the tail
    (training windows); "left" keeps the LAST max_len-1 bytes after BOS —
    the right choice for generation prompts, where the question sits at
    the end. Trimming counts encoded bytes, not characters."""
    raw = text.encode("utf-8")
    if max_len is not None and truncate == "left":
        raw = raw[-(max_len - 1):]
    ids = [BOS] + [b + BYTE_OFFSET for b in raw]
    if max_len is not None:
        ids = ids[:max_len]
    return np.asarray(ids, np.int32)


def decode_bytes(ids: Sequence[int]) -> str:
    out = bytes(i - BYTE_OFFSET for i in ids
                if i >= BYTE_OFFSET)
    return out.decode("utf-8", errors="replace")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 256 + NUM_SPECIAL
    hidden_dim: int = 384
    num_layers: int = 6
    num_heads: int = 6
    mlp_dim: int = 1536
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads


class Dense(nn.Linear):
    """Flax ``nn.Dense``: the product rounded to the dtype, then the bias
    (two roundings in bfloat16, where ``addmm`` would round once); the
    weight and bias cast to the input's dtype at use."""

    def forward(self, x):
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` op by op in x's dtype, its
    constants rounded to that dtype as JAX rounds them."""
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)  # noqa
    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def split_qkv(qkv: torch.Tensor, heads: int):
    """q, k and v [B, L, heads, head_dim] of a fused projection [B, L,
    3 * heads * head_dim] (its thirds in that order)."""
    b, length, _ = qkv.shape
    return (t.reshape(b, length, heads, -1) for t in qkv.chunk(3, dim=-1))


def causal_mask(length: int, key_valid, device) -> torch.Tensor:
    """[1 or B, 1, L, L] causal mask, pad keys (``key_valid`` [B, L] False)
    masked too."""
    mask = torch.ones(length, length, dtype=torch.bool,
                      device=device).tril()[None, None]
    return mask if key_valid is None else mask & key_valid[:, None, None, :]


def attend(q, keys, vals, mask, scale: float, dtype) -> torch.Tensor:
    """The attention of q [B, L, heads, hd] over keys and vals [B, M, heads,
    hd]: the score einsum in ``dtype``, then float32 times ``scale``, the
    mask and softmax in float32, the weights cast back to ``dtype`` for the
    einsum with vals -> [B, L, heads, hd]."""
    att = torch.einsum("blhd,bmhd->bhlm", q, keys).float() * scale
    att = torch.softmax(torch.where(mask, att, MASKED), dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", att.to(dtype), vals)


class _CausalBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, param_dtype=None):
        super().__init__()
        h, dt = cfg.hidden_dim, param_dtype or cfg.dtype
        self.cfg = cfg
        self.scale = float(np.float32(1.0 / np.sqrt(cfg.head_dim)))
        self.ln1 = _LayerNorm(h)
        self.qkv = Dense(h, 3 * h, dtype=dt)
        self.attn_out = Dense(h, h, dtype=dt)
        self.ln2 = _LayerNorm(h)
        self.mlp_in = Dense(h, cfg.mlp_dim, dtype=dt)
        self.mlp_out = Dense(cfg.mlp_dim, h, dtype=dt)

    def forward(self, x, cache=None, pos=None, key_valid=None):
        """x [B, L, H]. Without a cache: causal self-attention (with an
        optional [B, L] key-validity mask for left-padded batches); returns
        (x, (k, v)). With a cache (k, v buffers [B, M, heads, hd]) and
        ``pos`` (int): one decode step (L == 1) that writes k, v at ``pos``
        in place and attends to [0, pos] where ``key_valid`` [B, M] holds
        (the reference masks the later slots, which adds nothing)."""
        c = self.cfg
        h = self.ln1(x).to(c.dtype)
        b, length, _ = h.shape
        q, k, v = split_qkv(self.qkv(h), c.num_heads)
        if cache is None:
            keys, vals = k, v
            mask = causal_mask(length, key_valid, x.device)
            new_cache = (k, v)
        else:
            ck, cv = cache
            ck[:, pos:pos + 1] = k
            cv[:, pos:pos + 1] = v
            keys, vals = ck[:, :pos + 1], cv[:, :pos + 1]
            mask = (torch.ones(b, pos + 1, dtype=torch.bool, device=x.device)
                    if key_valid is None else key_valid[:, :pos + 1]
                    )[:, None, None, :]
            new_cache = cache
        out = attend(q, keys, vals, mask, self.scale, c.dtype)
        x = x + self.attn_out(out.reshape(b, length, c.hidden_dim))
        h = self.ln2(x).to(c.dtype)
        h = self.mlp_out(gelu_tanh(self.mlp_in(h)))
        return x + h, new_cache


class DecoderLM(nn.Module):
    def __init__(self, cfg: DecoderConfig, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        pdt = param_dtype or cfg.dtype
        self.tok = nn.Embedding(cfg.vocab_size, cfg.hidden_dim, dtype=pdt)
        self.pos = nn.Embedding(cfg.max_seq_len, cfg.hidden_dim, dtype=pdt)
        self.blocks = nn.ModuleList(_CausalBlock(cfg, param_dtype)
                                    for _ in range(cfg.num_layers))
        self.ln_f = _LayerNorm(cfg.hidden_dim)
        self.head = Dense(cfg.hidden_dim, cfg.vocab_size)   # float32

    def forward(self, ids, caches=None, pos=None, key_valid=None,
                pos_ids=None):
        """ids [B, L] -> (logits [B, L, V] f32, caches, hidden [B, L, H]
        f32).

        ``caches``: None (full causal forward / prefill) or per-layer
        (k, v) buffers with ``pos`` (the storage slot, an int) for one
        decode step. ``key_valid`` masks pad keys of left-padded batches;
        ``pos_ids`` [B, L] overrides the positional ids (per-row logical
        positions under left padding). ``hidden`` is ``ln_f``'s output, the
        reference's sown "intermediates/hidden" that the pointer heads of
        models/grounded.py read.
        """
        if pos_ids is None:
            pos_ids = (torch.arange(ids.shape[1], device=ids.device)[None]
                       if pos is None else
                       torch.full((1, ids.shape[1]), pos, device=ids.device))
        dt = self.cfg.dtype
        x = embed(self.tok, ids, dt) + embed(self.pos, pos_ids, dt)
        new_caches = []
        for i, block in enumerate(self.blocks):
            x, cache = block(x, None if caches is None else caches[i], pos,
                             key_valid)
            new_caches.append(cache)
        hidden = self.ln_f(x)
        return self.head(hidden), new_caches, hidden


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

def left_pad(prompts: Sequence[str], max_prompt_len: int):
    """Prompts as LEFT-padded byte ids [B, P] (their tails kept: in a RAG
    prompt the question comes last) and each row's pad count [B]."""
    ids = np.zeros((len(prompts), max_prompt_len), np.int64)
    pad_len = np.zeros(len(prompts), np.int64)
    for r, prompt in enumerate(prompts):
        row = encode_bytes(prompt, max_prompt_len, truncate="left")
        pad_len[r] = max_prompt_len - len(row)
        ids[r, pad_len[r]:] = row
    return ids, pad_len


def prefill_masks(pad_len: torch.Tensor, p: int, max_new: int):
    """(pad_mask [B, P], pos_ids [B, P], storage_valid [B, P+max_new]) of
    a left-padded batch."""
    col = torch.arange(p, device=pad_len.device)[None]
    pad_mask = col >= pad_len[:, None]
    pos_ids = torch.clamp_min(col - pad_len[:, None], 0)
    storage_valid = torch.cat([pad_mask, torch.ones(
        pad_mask.shape[0], max_new, dtype=torch.bool,
        device=pad_len.device)], dim=1)
    return pad_mask, pos_ids, storage_valid


def cache_buffers(caches, total: int):
    """Per-layer (k, v) of a prefill, each copied into a zeroed buffer of
    ``total`` slots."""
    out = []
    for k, v in caches:
        b, p, heads, hd = k.shape
        ck = k.new_zeros(b, total, heads, hd)
        cv = v.new_zeros(b, total, heads, hd)
        ck[:, :p], cv[:, :p] = k, v
        out.append((ck, cv))
    return out


def gumbel_pick(scores: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """A categorical sample per row of ``scores`` [B, V] (logits): the
    argmax after one Gumbel draw of [V] from ``gen``, shared by every
    row."""
    u = torch.rand(scores.shape[-1], generator=gen, device=scores.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(scores - torch.log(-torch.log(u)), dim=-1)


def decode_loop(first, step, pick, max_new: int, check_every: int = 16):
    """The reference's scan over ``max_new`` steps: ``pick`` a token per row
    from its scores, PAD where the row has finished, then ``step(toks, t)``
    to the next scores. Returns [max_new, B] tokens. Once every row has
    emitted EOS the rest would be PAD, so the loop stops there; it asks the
    device every ``check_every`` steps, not at every step."""
    b = first.shape[0]
    out = torch.full((max_new, b), PAD, dtype=torch.long, device=first.device)
    done = torch.zeros(b, dtype=torch.bool, device=first.device)
    scores = first
    for t in range(max_new):
        toks = torch.where(done, PAD, pick(scores))
        out[t] = toks
        done = done | (toks == EOS)
        if t + 1 == max_new or ((t + 1) % check_every == 0
                                and bool(done.all())):
            break
        scores = step(toks, t)
    return out


def texts_of(toks: torch.Tensor) -> list[str]:
    """[max_new, B] tokens -> one string a row, cut at its EOS."""
    out = []
    for row in toks.T.cpu().tolist():
        if EOS in row:
            row = row[: row.index(EOS)]
        out.append(decode_bytes(row))
    return out


class Generator:
    """Prefill + KV-cached decode text generation on ``device``.

    ``params`` is a DecoderLM state dict (``models/convert.
    decoder_flax_to_torch``); without it the weights are random from
    ``seed``.
    """

    def __init__(self, cfg: DecoderConfig | None = None, params=None,
                 seed: int = 0, max_prompt_len: int = 768,
                 max_new_tokens: int = 256, device="cuda"):
        self.cfg = cfg or DecoderConfig()
        if max_prompt_len + max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(f"{max_prompt_len} + {max_new_tokens} > "
                             f"max_seq_len {self.cfg.max_seq_len}")
        self.device = resolve_device(device)
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        self.model = serving_module(lambda: DecoderLM(self.cfg), params, seed,
                                    self.device)

    @torch.inference_mode()
    def _generate(self, ids, pad_len, temperature: float, top_k: int,
                  top_p: float, seed: int, max_new: int) -> torch.Tensor:
        """LEFT-padded ids [B, P] and pad counts [B] -> [max_new, B]."""
        p = ids.shape[1]
        if p + max_new > self.cfg.max_seq_len:
            raise ValueError(f"{p} + {max_new} > max_seq_len "
                             f"{self.cfg.max_seq_len}")
        pad_mask, pos_ids, storage_valid = prefill_masks(pad_len, p, max_new)
        logits, caches, _ = self.model(ids, key_valid=pad_mask,
                                       pos_ids=pos_ids)
        caches = cache_buffers(caches, p + max_new)

        def step(toks, t):
            pos = p + t
            nl, _, _ = self.model(toks[:, None], caches, pos, storage_valid,
                                  (pos - pad_len)[:, None])
            return nl[:, 0]

        if temperature <= 1e-4:
            pick = lambda lg: torch.argmax(lg, dim=-1)  # noqa: E731
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)

            def pick(lg):
                lg = lg / max(temperature, 1e-4)
                if top_k > 0:   # keep the k largest logits
                    kth = torch.sort(lg, dim=-1).values[:, -max(top_k, 1)]
                    lg = torch.where(lg >= kth[:, None], lg, MASKED)
                if top_p < 1.0:
                    # nucleus: the smallest prefix of the sorted
                    # distribution whose mass reaches top_p.
                    probs = torch.softmax(lg, dim=-1)
                    order = torch.argsort(-probs, dim=-1, stable=True)
                    sp = torch.gather(probs, 1, order)
                    cut = torch.cumsum(sp, dim=-1) - sp < top_p
                    keep = torch.zeros_like(cut).scatter(1, order, cut)
                    lg = torch.where(keep, lg, MASKED)
                return gumbel_pick(lg, gen)
        return decode_loop(logits[:, -1], step, pick, max_new)

    def generate_batch(self, prompts: list[str],
                       max_new_tokens: Optional[int] = None,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0, seed: int = 0) -> list[str]:
        """Batched generation: one prefill and one decode loop."""
        ids, pad_len = left_pad(prompts, self.max_prompt_len)
        return texts_of(self._generate(
            torch.from_numpy(ids).to(self.device),
            torch.from_numpy(pad_len).to(self.device), temperature, top_k,
            top_p, seed, max_new_tokens or self.max_new_tokens))

    def generate(self, prompt: str, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0) -> str:
        """top_k=0 disables the top-k filter; top_p=1.0 disables nucleus
        sampling; temperature<=0 is greedy (filters ignored)."""
        return self.generate_batch([prompt], max_new_tokens, temperature,
                                   top_k, top_p, seed)[0]

    @torch.inference_mode()
    def score(self, text: str) -> float:
        """Mean next-token log-prob (perplexity surrogate for tests)."""
        ids = torch.from_numpy(encode_bytes(text, self.cfg.max_seq_len)[None]
                               ).long().to(self.device)
        logits, _, _ = self.model(ids)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        return float(torch.gather(logp, -1, ids[:, 1:, None]).mean())


class LocalLMProvider:
    """LLMProvider backed by the on-device Generator.

    Generation quality depends on trained weights; structurally this
    completes the no-network serving path. ``fallback`` (default: the
    DeterministicLLM) answers structured/task-tagged calls the raw LM
    cannot, so the agent remains fully functional.
    """

    def __init__(self, generator: Generator, fallback=None,
                 temperature: float = 0.0):
        from optimized_rag_tpu_torch.agent.llm import DeterministicLLM
        self.generator = generator
        self.fallback = fallback or DeterministicLLM()
        self.temperature = temperature

    def complete(self, prompt: str, task: str = "", **kw) -> str:
        if task in ("generate", "cot", "synthesize"):
            # No host-side char trim: the generator tail-trims by encoded
            # bytes (UTF-8 chars may span several bytes).
            out = self.generator.generate(
                prompt,
                temperature=kw.get("temperature", self.temperature))
            if out.strip():
                return out
        return self.fallback.complete(prompt, task=task, **kw)

    def structured(self, prompt: str, keys, task: str = "", **kw):
        if task == "generate":
            # The answer itself comes from the decoder; citations are
            # whatever [N] markers the model emitted. Empty output falls
            # back so the agent keeps working with a weak checkpoint.
            out = self.generator.generate(
                prompt, temperature=kw.get("temperature",
                                           self.temperature))
            if out.strip():
                return {"answer": out.strip(),
                        "citations": sorted({
                            int(m) for m in re.findall(r"\[(\d+)\]", out)})}
        return self.fallback.structured(prompt, keys, task=task, **kw)
