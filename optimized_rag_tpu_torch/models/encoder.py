"""Transformer encoders and their services: the bi-encoder (embeddings)
and the cross-encoder (query, document) scorer.

Held against ``optimized_rag_tpu/models/encoder.py`` (:31-135, :142-299).
The numerics follow the Flax modules:

* the trunk's embeddings, attention and MLP run in bfloat16 (weights
  stored as float16 are rounded to bfloat16); LayerNorm and ``proj`` run in
  float32;
* LayerNorm uses eps 1e-6 and Flax's fast variance, E[x^2] - E[x]^2;
* attention scales q by 1/sqrt(head_dim) rounded to bfloat16, masks with
  the dtype's minimum (not -inf) and takes the softmax in bfloat16; it is
  written as matmuls plus softmax, as the JAX package leaves it to XLA;
* GELU is the tanh approximation;
* pooling is a masked mean, then ``proj``, then L2 normalisation with a
  1e-9 floor;
* the cross-encoder takes the trunk's [CLS] row (float32), then ``pool``,
  tanh and ``score``, all in float32; its service applies the sigmoid in
  float32.

Each model takes ``param_dtype``. The serving form (``None``) stores the
trunk's weights in ``cfg.dtype``. The training form (``torch.float32``)
keeps float32 master weights, as Flax does (``param_dtype`` left at
float32), and casts each to the compute dtype at its use: the embedding
tables to ``cfg.dtype`` before the gather, a Dense kernel and bias to its
input's dtype. Both forms run the same code and compute the same function;
the cast is a no-op in the serving form. ``flax_init_`` draws a fresh
model's weights from Flax's distributions.
"""

from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.models.tokenizer import HashTokenizer

_LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    hidden_dim: int = 384
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 1536
    max_seq_len: int = 512
    num_types: int = 2
    out_dim: int = 384          # embedding projection dim
    dtype: torch.dtype = torch.bfloat16   # trunk compute dtype
    dropout: float = 0.0


class _LayerNorm(nn.Module):
    """Flax LayerNorm in float32 (fast variance, eps 1e-6)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(dim=-1, keepdim=True)
                              - mean * mean, 0.0)
        return (x - mean) * (torch.rsqrt(var + _LN_EPS) * self.scale) \
            + self.bias


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to the input's dtype at
    use (Flax's Dense promotes its float32 kernel to the compute dtype)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def embed(table: nn.Embedding, ids, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Embed(dtype=...)``: the table cast to ``dtype``, then the
    gather (so its gradient accumulates in ``dtype`` too)."""
    return F.embedding(ids, table.weight.to(dtype))


class _Embeddings(nn.Module):
    def __init__(self, cfg: TransformerConfig, param_dtype=None):
        super().__init__()
        pdt = param_dtype or cfg.dtype
        self.dtype = cfg.dtype
        self.tok = nn.Embedding(cfg.vocab_size, cfg.hidden_dim, dtype=pdt)
        self.pos = nn.Embedding(cfg.max_seq_len, cfg.hidden_dim, dtype=pdt)
        self.typ = nn.Embedding(cfg.num_types, cfg.hidden_dim, dtype=pdt)
        self.ln = _LayerNorm(cfg.hidden_dim)

    def forward(self, ids, type_ids):
        pos_ids = torch.arange(ids.shape[-1], device=ids.device)[None, :]
        dt = self.dtype
        x = (embed(self.tok, ids, dt) + embed(self.pos, pos_ids, dt)
             + embed(self.typ, type_ids, dt))
        return self.ln(x).to(dt)


class _Attention(nn.Module):
    """Self-attention over ``heads`` of ``cfg``'s heads (all by default). A
    part of the heads (tensor parallelism, ``models/training.py``) has no
    ``out`` bias: the parts' outputs are summed, then the bias added."""

    def __init__(self, cfg: TransformerConfig, param_dtype=None,
                 heads: int | None = None):
        super().__init__()
        h, dt = cfg.hidden_dim, param_dtype or cfg.dtype
        self.heads = heads or cfg.num_heads
        width = self.heads * (h // cfg.num_heads)
        self.query = Linear(h, width, dtype=dt)
        self.key = Linear(h, width, dtype=dt)
        self.value = Linear(h, width, dtype=dt)
        self.out = Linear(width, h, bias=heads is None, dtype=dt)

    def forward(self, x, mask):
        b, length, _ = x.shape
        width = self.query.out_features
        hd = width // self.heads

        def split(t):                                   # [B, heads, L, hd]
            return t.view(b, length, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        q = q / torch.tensor(math.sqrt(hd), dtype=x.dtype, device=x.device)
        w = q @ k.transpose(-1, -2)                     # [B, heads, L, L]
        w = torch.where(mask[:, None, None, :].bool(), w,
                        torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        o = (w @ v).transpose(1, 2).reshape(b, length, width)
        return self.out(o)


class _Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, param_dtype=None):
        super().__init__()
        dt = param_dtype or cfg.dtype
        self.ln1 = _LayerNorm(cfg.hidden_dim)
        self.attn = _Attention(cfg, param_dtype)
        self.ln2 = _LayerNorm(cfg.hidden_dim)
        self.mlp_in = Linear(cfg.hidden_dim, cfg.mlp_dim, dtype=dt)
        self.mlp_out = Linear(cfg.mlp_dim, cfg.hidden_dim, dtype=dt)

    def forward(self, x, mask):
        dt = x.dtype
        x = x + self.attn(self.ln1(x).to(dt), mask)
        h = gelu(self.mlp_in(self.ln2(x).to(dt)))
        return x + self.mlp_out(h)


class _Trunk(nn.Module):
    def __init__(self, cfg: TransformerConfig, param_dtype=None):
        super().__init__()
        self.emb = _Embeddings(cfg, param_dtype)
        self.blocks = nn.ModuleList(_Block(cfg, param_dtype)
                                    for _ in range(cfg.num_layers))
        self.ln_f = _LayerNorm(cfg.hidden_dim)

    def forward(self, ids, mask, type_ids=None):
        if type_ids is None:
            type_ids = torch.zeros_like(ids)
        x = self.emb(ids, type_ids)
        for block in self.blocks:
            x = block(x, mask)
        return self.ln_f(x)                              # [B, L, H] f32


class BiEncoder(nn.Module):
    """Masked-mean-pooled sentence encoder producing unit vectors."""

    def __init__(self, cfg: TransformerConfig, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.trunk = _Trunk(cfg, param_dtype)
        self.proj = Linear(cfg.hidden_dim, cfg.out_dim)      # float32

    def forward(self, ids, mask):
        x = self.trunk(ids, mask)
        m = mask.float()[..., None]
        pooled = (x * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)
        out = self.proj(pooled)
        return out / torch.clamp_min(
            torch.linalg.vector_norm(out, dim=-1, keepdim=True), 1e-9)


class CrossEncoder(nn.Module):
    """(query, doc) pair scorer: [CLS] representation -> scalar logit."""

    def __init__(self, cfg: TransformerConfig, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.trunk = _Trunk(cfg, param_dtype)
        self.pool = Linear(cfg.hidden_dim, cfg.hidden_dim)      # float32
        self.score = Linear(cfg.hidden_dim, 1)                  # float32

    def forward(self, ids, mask, type_ids):
        cls = self.trunk(ids, mask, type_ids)[:, 0]             # [B, H] f32
        return self.score(torch.tanh(self.pool(cls)))[:, 0]


@torch.no_grad()
def flax_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw every weight of ``module`` from Flax's initialisers, in module
    order, from ``gen`` (a generator on the weights' device): a Linear's
    weight from ``lecun_normal`` (a normal truncated to two deviations,
    scaled to variance 1/fan_in), its bias zero; an Embedding from
    ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)`` (std
    1/sqrt(features)); a LayerNorm's scale one and bias zero. Flax's
    attention kernels ([H, heads, head_dim] and [heads, head_dim, H]) have
    fan_in H, as the Linear weights they flatten to."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / .87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0,
                                  generator=gen)
            m.weight.mul_(std)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                             generator=gen)
        elif isinstance(m, _LayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
    return module


def training_module(make, device, gen_seed: int) -> nn.Module:
    """``make()`` (a model in its float32 training form) built without
    torch's default initialisation, on ``device``, then Flax-initialised
    from a ``torch.Generator`` on that device seeded with ``gen_seed``."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    return flax_init_(module, gen)


def serving_module(make, params, seed: int, device) -> nn.Module:
    """``make()`` in eval mode on ``device``: with ``params`` (a full state
    dict) its weights are those, and torch's default initialisation is
    skipped; without, torch's default initialisation from ``seed``, the
    global generator left as it was."""
    if params is None:
        with torch.random.fork_rng(devices=[]):  # seeded init, no leak
            torch.manual_seed(seed)
            module = make()
        return module.to(device).eval()
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device)
    module.load_state_dict(params)          # strict: every weight is set
    return module.eval()


def _pad_rows(arrays, rows: int):
    """Zero rows appended to each [n, L] array up to ``rows``."""
    return [np.pad(a, ((0, rows - a.shape[0]), (0, 0))) for a in arrays]


class EmbeddingService:
    """Batched on-device embedding with an LRU cache.

    ``params`` is a BiEncoder state dict (``models/convert.flax_to_torch``);
    without it the weights are random from ``seed``. Batches are padded to
    the same buckets as the JAX service, and the cache is shared by
    concurrent callers under a lock.
    """

    BATCH_BUCKETS = (8, 32, 64, 128)

    def __init__(self, cfg: TransformerConfig | None = None, params=None,
                 seed: int = 0, cache_size: int = 4096, max_len: int = 128,
                 matryoshka_dim: int | None = None, tokenizer=None,
                 device="cuda"):
        self.cfg = cfg or TransformerConfig()
        self.device = resolve_device(device)
        self.max_len = max_len
        self.matryoshka_dim = matryoshka_dim
        self.tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size,
                                                    max_len)
        self.model = serving_module(lambda: BiEncoder(self.cfg), params, seed,
                                    self.device)
        self._cache: dict[str, np.ndarray] = {}
        self._cache_size = cache_size
        self._cache_lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0}

    @property
    def dim(self) -> int:
        return self.matryoshka_dim or self.cfg.out_dim

    def _bucket_batch(self, n: int) -> int:
        for b in self.BATCH_BUCKETS:
            if n <= b:
                return b
        return -(-n // self.BATCH_BUCKETS[-1]) * self.BATCH_BUCKETS[-1]

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = self.model(torch.from_numpy(ids).long().to(self.device),
                             torch.from_numpy(mask).to(self.device))
        return out.float().cpu().numpy()

    def encode(self, texts: list[str]) -> np.ndarray:
        """Embed a list of texts -> [n, dim] float32 unit vectors."""
        out = np.zeros((len(texts), self.dim), np.float32)
        todo_idx: list[int] = []
        seen: dict[str, list[int]] = {}
        with self._cache_lock:
            for i, t in enumerate(texts):
                hit = self._cache.get(t)
                if hit is not None:
                    out[i] = hit
                    self.stats["hits"] += 1
                elif t in seen:          # duplicate within this batch
                    seen[t].append(i)
                    self.stats["hits"] += 1
                else:
                    seen[t] = []
                    todo_idx.append(i)
                    self.stats["misses"] += 1
        if todo_idx:
            todo = [texts[i] for i in todo_idx]
            ids, mask = self.tokenizer.encode_batch(todo, self.max_len)
            ids, mask = _pad_rows((ids, mask), self._bucket_batch(len(todo)))
            emb = self._forward(ids, mask)[:len(todo)]
            if self.matryoshka_dim:
                emb = np.array(emb[:, :self.matryoshka_dim])
                emb /= np.maximum(
                    np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
            with self._cache_lock:
                for j, i in enumerate(todo_idx):
                    out[i] = emb[j]
                    for dup in seen.get(texts[i], ()):
                        out[dup] = emb[j]
                    self._cache_insert(texts[i], emb[j])
        return out

    def _cache_insert(self, text: str, vec: np.ndarray) -> None:
        """LRU insert; caller holds the lock. cache_size<=0 disables."""
        if self._cache_size <= 0:
            return
        while len(self._cache) >= self._cache_size:
            self._cache.pop(next(iter(self._cache)))
        self._cache[text] = vec

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]

    def cache_put(self, text: str, vec: np.ndarray) -> None:
        """Insert an embedding computed elsewhere (the query vector that
        comes back in the fused query's packed result, ops/fused_query.py),
        so later stages hit the cache instead of running a forward."""
        with self._cache_lock:
            self._cache_insert(text, np.asarray(vec, np.float32))

    def cache_stats(self) -> dict:
        total = self.stats["hits"] + self.stats["misses"]
        return {**self.stats,
                "hit_rate": self.stats["hits"] / total if total else 0.0,
                "entries": len(self._cache)}


class CrossEncoderService:
    """Batched (query, doc) pair scoring on ``device``.

    ``params`` is a CrossEncoder state dict (``models/convert.flax_to_torch``);
    without it the weights are random from ``seed``. Pairs are padded to the
    JAX service's batch buckets and scored in one forward; the logits go
    through a float32 sigmoid.
    """

    BATCH_BUCKETS = (8, 32, 64)

    def __init__(self, cfg: TransformerConfig | None = None, params=None,
                 seed: int = 1, max_len: int = 256, tokenizer=None,
                 device="cuda"):
        self.cfg = cfg or TransformerConfig()
        self.device = resolve_device(device)
        self.max_len = max_len
        self.tokenizer = tokenizer or HashTokenizer(self.cfg.vocab_size,
                                                    max_len)
        self.model = serving_module(lambda: CrossEncoder(self.cfg), params,
                                    seed, self.device)

    def _bucket_batch(self, n: int) -> int:
        return next((b for b in self.BATCH_BUCKETS if n <= b),
                    -(-n // self.BATCH_BUCKETS[-1]) * self.BATCH_BUCKETS[-1])

    def logits(self, ids, mask, types) -> torch.Tensor:
        """Forward of token pairs (numpy or tensors) -> [n] float32 logits
        on the device."""
        t = lambda a: torch.as_tensor(a).to(self.device).long()
        with torch.inference_mode():
            return self.model(t(ids), t(mask), t(types)).float()

    def score_pairs(self, query: str, docs: list[str]) -> np.ndarray:
        """Sigmoid relevance scores [len(docs)] in [0, 1]."""
        if not docs:
            return np.zeros(0, np.float32)
        ids, mask, types = self.tokenizer.encode_pairs(
            [(query, d) for d in docs], self.max_len)
        n = len(docs)
        padded = _pad_rows((ids, mask, types), self._bucket_batch(n))
        logits = self.logits(*padded).cpu().numpy()[:n]
        return (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
