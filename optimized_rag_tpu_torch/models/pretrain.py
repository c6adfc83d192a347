"""Self-supervised pretraining of the retrieval models and the decoder LMs,
and checkpoint discovery.

Held against ``optimized_rag_tpu/models/pretrain.py`` (:45-471). Trained
checkpoints come from any text corpus with zero labels:

  * Bi-encoder: Inverse Cloze Task (ICT): the query is a random word span
    drawn from a chunk, the positive is the chunk itself; in-batch
    negatives drive the symmetric InfoNCE loss (models/training.py).
  * Cross-encoder: pointwise relevance: (span, own chunk) -> 1,
    (span, random other chunk) -> 0, sigmoid BCE.
  * Decoder LM: next-byte cross-entropy over sliding windows.
  * Grounded pointer-generator: synthesized grounded-QA rows
    (models/grounded_data.py).

The samplers draw from ``np.random.default_rng(seed)`` as the JAX package
does, so the same seed gives the same batches. A checkpoint is
``<name>.config.json`` plus ``<name>.params.npz`` in the JAX package's
layout (``save_pretrained`` writes it through ``models/convert``'s
inverse converters; either package reads it). ``load_pretrained`` returns
the port's configuration of its family and a torch state dict; the agent
finds checkpoints with ``find_checkpoint_dir``.

The trainers run on a port ``Mesh`` (``models/training.py``); ``mesh=None``
lays the data axis over every CUDA device (``device="cuda"``, the default)
or over ``device`` alone, and raises without a card unless given the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from optimized_rag_tpu_torch.models import convert, loader
from optimized_rag_tpu_torch.models.encoder import TransformerConfig

_WORDS = re.compile(r"[\w#]+")


# ---------------------------------------------------------------------------
# Example synthesis (self-supervised, label-free)
# ---------------------------------------------------------------------------

class ICTSampler:
    """Inverse-Cloze-Task pair sampler with the corpus tokenized ONCE."""

    def __init__(self, texts: Sequence[str], min_span: int = 2,
                 max_span: int = 8):
        self.texts = list(texts)
        self.min_span = min_span
        self.max_span = max_span
        self.words_per = [_WORDS.findall(t.lower()) for t in self.texts]
        self.usable = np.asarray(
            [i for i, w in enumerate(self.words_per) if len(w) >= min_span])
        if len(self.usable) == 0:
            raise ValueError("no usable training texts")

    def sample(self, rng: np.random.Generator, n: int):
        """Returns (query spans, source chunks, chunk indices)."""
        queries, docs = [], []
        picks = rng.choice(self.usable, n)
        for i in picks:
            words = self.words_per[i]
            span = int(rng.integers(self.min_span, self.max_span + 1))
            start = int(rng.integers(0, max(len(words) - span, 0) + 1))
            queries.append(" ".join(words[start:start + span]))
            docs.append(self.texts[i])
        return queries, docs, picks


def ict_pairs(texts: Sequence[str], rng: np.random.Generator, n: int,
              min_span: int = 2, max_span: int = 8):
    """Inverse-Cloze-Task pairs: (query span, source chunk)."""
    return ICTSampler(texts, min_span, max_span).sample(rng, n)


def _encode_batch(tokenizer, texts, max_len):
    return tokenizer.encode_batch(list(texts), max_len)


def default_mesh(device="cuda"):
    """A (data, model=1) mesh: every CUDA device for ``"cuda"``, else the
    one device named. Raises without a card unless given the CPU."""
    from optimized_rag_tpu_torch.device import resolve_device
    from optimized_rag_tpu_torch.parallel.mesh import make_mesh
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh(model=1)
    return make_mesh(data=1, devices=[dev])


def _resume(snapshot_dir, name, log, realign, said):
    """(start step, float32 params) of an interrupted run's snapshot, the
    sampler realigned by ``realign(start)`` and ``said(snapshot step)``
    logged; (0, None) without one."""
    marker = (os.path.join(snapshot_dir, f"{name}.step.txt")
              if snapshot_dir else None)
    if not (marker and os.path.exists(marker)):
        return 0, None
    ck = load_pretrained(snapshot_dir, name, param_dtype=torch.float32)
    if ck is None:
        return 0, None
    with open(marker) as f:
        start = int(f.read().strip()) + 1
    realign(start)
    if log:
        log(said(start - 1))
    return start, ck[1]


def _shifted(learning_rate, start_step):
    """A callable learning rate continues from ``start_step``."""
    if start_step and callable(learning_rate):
        return lambda count, _sched=learning_rate: _sched(count + start_step)
    return learning_rate


def _snapshot(snapshot_dir, name, params, cfg, step, log, what):
    save_pretrained(snapshot_dir, name, params, cfg)
    with open(os.path.join(snapshot_dir, f"{name}.step.txt"), "w") as fh:
        fh.write(str(step))
    if log:
        log(what)


def _finish(snapshot_dir, name):
    """A completed run removes its marker: a future run starts fresh."""
    marker = (os.path.join(snapshot_dir, f"{name}.step.txt")
              if snapshot_dir else None)
    if marker and os.path.exists(marker):
        os.remove(marker)


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------

def train_biencoder(texts: Sequence[str], cfg: TransformerConfig,
                    mesh=None, steps: int = 200, batch: int = 64,
                    learning_rate=3e-4, max_len: int = 64,
                    seed: int = 0,
                    log: Optional[Callable[[str], None]] = None,
                    tok=None, snapshot_dir: Optional[str] = None,
                    snapshot_every: int = 1000,
                    query_transform: Optional[Callable] = None,
                    device="cuda"):
    """ICT-pretrain a BiEncoder; returns (params, last_loss).

    ``query_transform(queries) -> queries`` is applied to each step's query
    spans before tokenization (positives untouched), the cross-lingual
    augmentation hook (models/xlingual.augment_queries); it must be
    deterministic in its inputs: the resume replay re-samples the stream
    but does not re-run it.

    ``snapshot_dir`` persists the in-flight params every
    ``snapshot_every`` steps (a ``biencoder`` checkpoint plus a
    ``biencoder.step.txt`` marker); a relaunch with the same directory
    resumes after the marker's step, the data stream realigned by
    replaying the sampler and a callable ``learning_rate`` shifted by the
    resumed step. Optimizer moments are not snapshotted: they rewarm.
    """
    from optimized_rag_tpu_torch.models.tokenizer import HashTokenizer
    from optimized_rag_tpu_torch.models.training import BiEncoderTrainer
    mesh = mesh or default_mesh(device)
    rng = np.random.default_rng(seed)
    tok = tok or HashTokenizer(cfg.vocab_size, max_len)
    sampler = ICTSampler(texts)
    start_step, resume_params = _resume(
        snapshot_dir, "biencoder", log,
        lambda n: [sampler.sample(rng, batch) for _ in range(n)],
        lambda at: f"resuming from snapshot step {at} in {snapshot_dir}")
    trainer = BiEncoderTrainer(cfg, mesh, learning_rate=_shifted(
        learning_rate, start_step), seed=seed)
    if resume_params is not None:
        trainer.params = resume_params

    loss = float("nan")
    t0 = time.time()
    for step in range(start_step, steps):
        q, d, _ = sampler.sample(rng, batch)
        if query_transform is not None:
            q = query_transform(q)
        q_ids, q_mask = _encode_batch(tok, q, max_len)
        d_ids, d_mask = _encode_batch(tok, d, max_len)
        loss = trainer.train_step(q_ids, q_mask, d_ids, d_mask)
        if log and (step % 25 == 0 or step == steps - 1):
            log(f"biencoder step {step}: loss={loss:.4f} "
                f"({time.time() - t0:.0f}s)")
        if (snapshot_dir and step and step % snapshot_every == 0
                and step != steps - 1):
            _snapshot(snapshot_dir, "biencoder", trainer.params, cfg, step,
                      log, f"snapshot at step {step} -> {snapshot_dir}")
    _finish(snapshot_dir, "biencoder")
    return trainer.params, loss


def train_cross_encoder(texts: Sequence[str], cfg: TransformerConfig,
                        mesh=None, steps: int = 200, batch: int = 64,
                        learning_rate=3e-4, max_len: int = 96,
                        seed: int = 0,
                        log: Optional[Callable[[str], None]] = None,
                        tok=None, device="cuda"):
    """Pointwise-pretrain a CrossEncoder; returns (params, last_loss)."""
    from optimized_rag_tpu_torch.models.tokenizer import HashTokenizer
    from optimized_rag_tpu_torch.models.training import CrossEncoderTrainer
    mesh = mesh or default_mesh(device)
    rng = np.random.default_rng(seed)
    # Pair sequences longer than the position table would index past it:
    # clamp to it.
    max_len = min(max_len, cfg.max_seq_len)
    tok = tok or HashTokenizer(cfg.vocab_size, max_len)
    trainer = CrossEncoderTrainer(cfg, mesh, learning_rate=learning_rate,
                                  seed=seed)
    sampler = ICTSampler(texts)
    loss = float("nan")
    t0 = time.time()
    half = batch // 2
    for step in range(steps):
        q, d, picks = sampler.sample(rng, half)
        # negatives: same spans against different chunks
        neg_idx = rng.integers(0, len(texts), half)
        neg_idx = np.where(neg_idx == picks,
                           (neg_idx + 1) % len(texts), neg_idx)
        pairs = [(qq, dd) for qq, dd in zip(q, d)] + \
                [(qq, texts[j]) for qq, j in zip(q, neg_idx)]
        labels = np.concatenate([np.ones(half, np.float32),
                                 np.zeros(half, np.float32)])
        ids, mask, types = tok.encode_pairs(pairs, max_len)
        loss = trainer.train_step(ids, mask, types, labels)
        if log and (step % 25 == 0 or step == steps - 1):
            log(f"cross-encoder step {step}: loss={loss:.4f} "
                f"({time.time() - t0:.0f}s)")
    return trainer.params, loss


def train_decoder(texts: Sequence[str], cfg, mesh=None, steps: int = 200,
                  batch: int = 32, learning_rate=3e-4,
                  seed: int = 0,
                  log: Optional[Callable[[str], None]] = None,
                  device="cuda"):
    """Next-byte LM pretraining; returns (params, last_loss)."""
    from optimized_rag_tpu_torch.models.decoder import PAD, encode_bytes
    from optimized_rag_tpu_torch.models.training import DecoderTrainer
    mesh = mesh or default_mesh(device)
    rng = np.random.default_rng(seed)
    window = cfg.max_seq_len
    trainer = DecoderTrainer(cfg, mesh, learning_rate=learning_rate,
                             seed=seed)
    raw = "\n".join(texts).encode("utf-8")
    loss = float("nan")
    t0 = time.time()
    for step in range(steps):
        rows = np.full((batch, window), PAD, np.int32)
        for r in range(batch):
            start = int(rng.integers(0, max(len(raw) - window, 0) + 1))
            ids = encode_bytes(raw[start:start + window - 1]
                               .decode("utf-8", errors="replace"), window)
            rows[r, :len(ids)] = ids
        loss = trainer.train_step(rows)
        if log and (step % 25 == 0 or step == steps - 1):
            log(f"decoder step {step}: loss={loss:.4f} "
                f"({time.time() - t0:.0f}s)")
    return trainer.params, loss


def train_grounded(texts: Sequence[str], cfg, mesh=None, steps: int = 2000,
                   batch: int = 8, learning_rate=3e-4,
                   seed: int = 0, prompt_len: int = 2560,
                   target_len: int = 320,
                   log: Optional[Callable[[str], None]] = None,
                   snapshot_dir: Optional[str] = None,
                   snapshot_every: int = 1000,
                   early_weight: float = 8.0, early_len: int = 6,
                   device="cuda"):
    """Pointer-generator training on synthesized grounded-QA rows
    (models/grounded_data.GroundedSampler). Snapshot/resume as in
    ``train_biencoder``. Returns (params, last_nll)."""
    from optimized_rag_tpu_torch.models.grounded import GroundedTrainer
    from optimized_rag_tpu_torch.models.grounded_data import GroundedSampler
    mesh = mesh or default_mesh(device)
    rng = np.random.default_rng(seed)
    sampler = GroundedSampler(texts, prompt_len=prompt_len,
                              target_len=target_len)
    start_step, resume_params = _resume(
        snapshot_dir, "grounded", log,
        lambda n: [sampler.batch(rng, batch) for _ in range(n)],
        lambda at: f"resuming grounded from step {at}")
    trainer = GroundedTrainer(cfg, mesh, prompt_len=prompt_len,
                              target_len=target_len,
                              learning_rate=_shifted(learning_rate,
                                                     start_step),
                              seed=seed, early_weight=early_weight,
                              early_len=early_len)
    if resume_params is not None:
        trainer.params = resume_params
    nll = float("nan")
    t0 = time.time()
    for step in range(start_step, steps):
        ids, pad_len, copy_tgt = sampler.batch(rng, batch)
        nll, closs = trainer.train_step(ids, pad_len, copy_tgt)
        if log and (step % 25 == 0 or step == steps - 1):
            log(f"grounded step {step}: nll={nll:.4f} copy={closs:.4f} "
                f"({time.time() - t0:.0f}s)")
        if (snapshot_dir and step and step % snapshot_every == 0
                and step != steps - 1):
            _snapshot(snapshot_dir, "grounded", trainer.params, cfg, step,
                      log, f"grounded snapshot at step {step}")
    _finish(snapshot_dir, "grounded")
    return trainer.params, nll


# ---------------------------------------------------------------------------
# Checkpoint round-trip (params + architecture config side file)
# ---------------------------------------------------------------------------

def _flax_params(params: dict, cfg) -> dict:
    """A port state dict as the JAX package's flat npz keys (the inverse
    converter of the config's family)."""
    if hasattr(cfg, "out_dim"):
        return convert.torch_to_flax(params, cfg)
    if hasattr(cfg, "copy_dim"):
        return convert.grounded_torch_to_flax(params, cfg)
    return convert.decoder_torch_to_flax(params, cfg)


def save_pretrained(path: str, name: str, params, cfg,
                    store_dtype=None) -> None:
    """Persist params (npz, the JAX package's keys and shapes) and the
    architecture config (json, ``dataclasses.asdict`` with the dtype's
    name), as the JAX package does. ``params`` is a port state dict;
    ``store_dtype`` (e.g. np.float16) halves the size on disk, and loading
    restores float32."""
    flat = _flax_params(params, cfg)
    if store_dtype is not None:
        flat = {k: v.astype(store_dtype)
                if np.issubdtype(v.dtype, np.floating) else v
                for k, v in flat.items()}
    loader.save_params(path, name, flat)
    blob = dataclasses.asdict(cfg)
    if "dtype" in blob:
        blob["dtype"] = convert.dtype_name(blob["dtype"])
    with open(os.path.join(path, f"{name}.config.json"), "w") as f:
        json.dump(blob, f, indent=1, default=str)


def load_pretrained(path: str, name: str,
                    param_dtype=None) -> Optional[tuple]:
    """Returns (cfg, state_dict) of a checkpoint, or None when none
    exists. The family follows the config as in the reference: ``out_dim``
    marks an encoder, ``copy_dim`` the grounded generator, anything else
    the decoder LM. The state dict is in the serving form's dtypes, or all
    in ``param_dtype`` (float32 for a trainer)."""
    cfg_path = os.path.join(path, f"{name}.config.json")
    params_path = os.path.join(path, f"{name}.params.npz")
    if not (os.path.exists(cfg_path) and os.path.exists(params_path)):
        return None
    with open(cfg_path) as f:
        blob = json.load(f)
    params = convert.load_params(path, name)
    if "out_dim" in blob:  # encoder family
        cfg = convert.load_config(path, name)
        return cfg, convert.flax_to_torch(params, cfg, param_dtype)
    fields = {f: int(blob[f]) for f in (
        "vocab_size", "hidden_dim", "num_layers", "num_heads", "mlp_dim",
        "max_seq_len")}
    fields["dtype"] = convert.config_dtype(blob)
    if "copy_dim" in blob:  # grounded pointer-generator family
        from optimized_rag_tpu_torch.models.grounded import GroundedConfig
        cfg = GroundedConfig(
            **fields, copy_dim=int(blob["copy_dim"]),
            prompt_len=int(blob.get("prompt_len",
                                    fields["max_seq_len"] - 320)),
            target_len=int(blob.get("target_len", 320)))
        return cfg, convert.grounded_flax_to_torch(params, cfg, param_dtype)
    from optimized_rag_tpu_torch.models.decoder import DecoderConfig
    cfg = DecoderConfig(**fields)
    return cfg, convert.decoder_flax_to_torch(params, cfg, param_dtype)


def find_checkpoint_dir(data_dir: str) -> Optional[str]:
    """Search order: user data dir, then the repo's bundled checkpoints."""
    candidates = [
        os.path.join(data_dir, "models"),
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            "checkpoints", "pretrained"),
    ]
    for c in candidates:
        if os.path.exists(os.path.join(c, "biencoder.params.npz")):
            return c
    return None


load_tokenizer = convert.load_tokenizer


# ---------------------------------------------------------------------------
# Corpus assembly + end-to-end pretraining run
# ---------------------------------------------------------------------------

def default_corpus(extra_texts: Sequence[str] = ()) -> List[str]:
    """Training corpus: the synthetic topic dataset (gives the eval its
    known-relevance structure) mixed with any real chunks supplied."""
    from optimized_rag_tpu_torch.eval.synthetic import make_dataset
    ds = make_dataset(num_docs=600, num_topics=30, num_queries=1,
                      seed=1234)
    return list(extra_texts) + ds.texts


def pretrain_all(out_dir: str, texts: Sequence[str], *,
                 encoder_cfg: TransformerConfig,
                 cross_cfg: TransformerConfig,
                 decoder_cfg=None, mesh=None, steps: int = 200,
                 batch: int = 64, store_dtype=None, decoder_texts=None,
                 learned_vocab: bool = False,
                 log: Optional[Callable[[str], None]] = print,
                 device="cuda") -> dict:
    """Train bi-encoder + cross-encoder (+ decoder) and persist all three.
    Returns summary losses. ``learned_vocab`` trains a corpus top-word
    vocabulary and persists it beside the weights. ``mesh=None`` builds
    ``default_mesh(device)``."""
    mesh = mesh or default_mesh(device)
    out = {}
    tok = None
    if learned_vocab:
        from optimized_rag_tpu_torch.models.tokenizer import VocabTokenizer
        t0 = time.time()
        tok = VocabTokenizer.train(texts, encoder_cfg.vocab_size)
        os.makedirs(out_dir, exist_ok=True)
        tok.save(os.path.join(out_dir, "tokenizer.vocab.txt"))
        if log:
            log(f"learned vocab: {len(tok.words)} words "
                f"({time.time() - t0:.0f}s)")
        out["vocab_words"] = len(tok.words)
    params, loss = train_biencoder(texts, encoder_cfg, mesh, steps=steps,
                                   batch=batch, log=log, tok=tok)
    save_pretrained(out_dir, "biencoder", params, encoder_cfg,
                    store_dtype=store_dtype)
    out["biencoder_loss"] = loss
    params, loss = train_cross_encoder(texts, cross_cfg, mesh, steps=steps,
                                       batch=batch, log=log, tok=tok)
    save_pretrained(out_dir, "crossencoder", params, cross_cfg,
                    store_dtype=store_dtype)
    out["crossencoder_loss"] = loss
    if decoder_cfg is not None:
        params, loss = train_decoder(decoder_texts or texts, decoder_cfg,
                                     mesh, steps=steps,
                                     batch=max(batch // 2, 8), log=log)
        save_pretrained(out_dir, "decoder", params, decoder_cfg,
                        store_dtype=store_dtype)
        out["decoder_loss"] = loss
    return out
