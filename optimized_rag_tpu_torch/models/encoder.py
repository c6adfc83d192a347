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
import queue
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.models.tokenizer import HashTokenizer
from optimized_rag_tpu_torch.utils.profiling import span

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
        # A fill, not a host copy: the copy would wait for the stream and
        # cannot be captured in a CUDA graph (``EmbeddingService``).
        q = q / torch.full((), math.sqrt(hd), dtype=x.dtype, device=x.device)
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


class _ForwardGraph:
    """``model``'s forward at one padded shape, captured as a CUDA graph on
    a static token buffer ``tok`` ([2, B, L]: the ids, then the mask; a
    copy of the first call's) into a static output ``out``: one eager run
    on a side stream first (cuBLAS sets up its workspace for the stream
    there), then the capture on that stream. ``like``, an earlier graph of
    the same slot, lends its side stream and memory pool. The capture errs
    only on this thread's unsafe calls, so another thread may issue work
    meanwhile. A replay runs on the current stream: the same kernels at
    the same shapes as the eager forward."""

    def __init__(self, model, tok, like: "_ForwardGraph | None" = None):
        self.tok = tok.clone()
        self.out = self._capture(model, like)

    def _capture(self, model, like):
        dev = self.tok.device
        self.stream = like.stream if like else torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            model(*self.tok)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph,
                              pool=like.graph.pool() if like else None,
                              stream=self.stream,
                              capture_error_mode="thread_local"):
            return model(*self.tok)

    def replay(self) -> None:
        self.graph.replay()


class EmbeddingService:
    """Batched on-device embedding with an LRU cache.

    ``params`` is a BiEncoder state dict (``models/convert.flax_to_torch``);
    without it the weights are random from ``seed``. Batches are padded to
    the same buckets as the JAX service, and the cache is shared by
    concurrent callers under a lock.

    On a CUDA device each padded shape of a batch bucket by a length of the
    tokenizer's ladder (``graphable``: 20 shapes at ``max_len`` 128) is
    captured as CUDA graphs at its first use and replayed after
    (``_ForwardGraph``); larger batches, and every forward on the CPU, run
    eagerly. A shape has a graph in each of ``GRAPH_SLOTS`` slots, and a
    caller holds a slot from its upload to its fetch: the tokens go
    straight into the slot's static buffer, the replay follows, and the
    fetch copies the slot's static output back and waits for it; only
    then is the slot free again. So a call issues three operations, and
    two callers (``QueryServer``'s workers) replay side by side without a
    lock; a third waits for a slot. The graphs of a slot share one memory
    pool (only the slot's holder replays them, one at a time, and its
    fetch has waited for the replay before the next one), so the service
    holds one pool a slot. Since the fetch waits for the slot's work,
    this holds on any streams the callers issue on.
    """

    BATCH_BUCKETS = (8, 32, 64, 128)
    GRAPH_SLOTS = 2          # callers replaying at once: QueryServer's workers

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
        # The padded lengths the tokenizer gives (``_bucket_len``'s ladder).
        self._lengths = frozenset(HashTokenizer._bucket_len(n, max_len)
                                  for n in range(1, max_len + 1))
        # The graph type: None where the device has no CUDA graphs.
        self._graph_type = (_ForwardGraph if self.device.type == "cuda"
                            else None)
        self._graphs: dict[tuple[int, int], list[_ForwardGraph]] = {}
        self._slots = queue.SimpleQueue()
        for slot in range(self.GRAPH_SLOTS):
            self._slots.put(slot)
        self._replays = [0] * self.GRAPH_SLOTS   # counted by the slot's holder
        self._graph_lock = threading.Lock()      # captures, eager count
        self._graph_counts = {"captures": 0, "eager": 0}

    @property
    def dim(self) -> int:
        return self.matryoshka_dim or self.cfg.out_dim

    def _bucket_batch(self, n: int) -> int:
        for b in self.BATCH_BUCKETS:
            if n <= b:
                return b
        return -(-n // self.BATCH_BUCKETS[-1]) * self.BATCH_BUCKETS[-1]

    def graphable(self, batch: int, length: int) -> bool:
        """Whether a forward of ``batch`` x ``length`` padded tokens runs
        as a CUDA graph on a CUDA device: a batch bucket by a length of
        the tokenizer's ladder up to ``max_len``."""
        return batch in self.BATCH_BUCKETS and length in self._lengths

    def graph_stats(self) -> dict:
        """Forwards so far: ``captures`` (graphs captured: ``GRAPH_SLOTS``
        a shape), ``replays`` (graph forwards, a shape's first included)
        and ``eager``."""
        with self._graph_lock:
            return {**self._graph_counts, "replays": sum(self._replays)}

    def _capture(self, tok: torch.Tensor) -> list[_ForwardGraph]:
        """The graphs of ``tok``'s shape ([2, B, L] on the device), one a
        slot, captured if no caller has yet; the slots' pools are those of
        their earlier graphs."""
        key = tuple(tok.shape[1:])
        with self._graph_lock:
            graphs = self._graphs.get(key)
            if graphs is None:
                first = next(iter(self._graphs.values()),
                             [None] * self.GRAPH_SLOTS)
                graphs = [self._graph_type(self.model, tok, like)
                          for like in first]
                self._graphs[key] = graphs
                self._graph_counts["captures"] += len(graphs)
        return graphs

    def _forward_graph(self, ids: np.ndarray, mask: np.ndarray):
        """The forward by a slot's graph of its shape (see the class's
        docstring), captured first if new."""
        slot = self._slots.get()
        try:
            with torch.inference_mode():
                with span("encode.upload"):     # ids and mask in one copy
                    tok = torch.from_numpy(np.stack((ids, mask)))
                    graphs = self._graphs.get(ids.shape)
                    if graphs is None:
                        tok = tok.to(self.device)
                    else:
                        graphs[slot].tok.copy_(tok)
                with span("encode.forward") as sp:
                    if sp:
                        sp.attrs["graph"] = 1
                    if graphs is None:
                        graphs = self._capture(tok)
                        graphs[slot].tok.copy_(tok)
                    graphs[slot].replay()
                    self._replays[slot] += 1
                with span("encode.fetch"):
                    return graphs[slot].out.to("cpu", copy=True).numpy()
        finally:
            self._slots.put(slot)

    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        if self._graph_type is not None and self.graphable(*ids.shape):
            return self._forward_graph(ids, mask)
        with torch.inference_mode():
            with span("encode.upload"):     # ids and mask in one copy
                tok = torch.from_numpy(np.stack((ids, mask))).to(self.device)
            with span("encode.forward") as sp:
                if sp:
                    sp.attrs["graph"] = 0
                out = self.model(*tok)
                with self._graph_lock:
                    self._graph_counts["eager"] += 1
            with span("encode.fetch"):
                return out.float().cpu().numpy()

    def encode(self, texts: list[str]) -> np.ndarray:
        """Embed a list of texts -> [n, dim] float32 unit vectors.

        While a profiler session is active it records ``encode`` (texts,
        misses, bucket) and, under it, ``encode.cache`` (the lookup under
        the lock), ``encode.tokenize`` (tokenizer and padding),
        ``encode.upload`` (the tokens' copy to the device, into a graph's
        buffer where the shape has one, which waits for the work queued on
        its stream), ``encode.forward`` (the forward issued: a graph's
        replay, its capture first if new, with ``graph`` 1; the module call
        with ``graph`` 0), ``encode.fetch`` (the wait for the device and
        the copy back) and ``encode.store`` (the Matryoshka cut and the
        cache insert)."""
        with span("encode") as sp:
            out = np.zeros((len(texts), self.dim), np.float32)
            todo_idx: list[int] = []
            seen: dict[str, list[int]] = {}
            with span("encode.cache"), self._cache_lock:
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
            if sp:
                sp.attrs.update(texts=len(texts), misses=len(todo_idx))
            if todo_idx:
                todo = [texts[i] for i in todo_idx]
                bucket = self._bucket_batch(len(todo))
                with span("encode.tokenize"):
                    ids, mask = self.tokenizer.encode_batch(todo,
                                                            self.max_len)
                    ids, mask = _pad_rows((ids, mask), bucket)
                if sp:
                    sp.attrs["bucket"] = bucket
                emb = self._forward(ids, mask)[:len(todo)]
                with span("encode.store"):
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
