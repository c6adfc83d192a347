"""The system under test, built from a configuration file.

A configuration names the program's parts and their settings:

* ``index``: ``DenseIndex(dim, capacity_block, dtype, tile)``, filled with
  the rows of ``corpus`` (a generator under ``portbench/corpus/``);
* ``encoder`` (optional): the checkpoint the program's ``load_biencoder``
  loads into an ``EmbeddingService``;
* ``server`` (optional): ``QueryServer(embed_fn, index, max_batch,
  max_wait_ms, max_k, workers)`` over the two.

The benchmark hands the program only the rows and, through the traffic,
the queries. The inputs it made are kept on ``System`` for the check.
"""

from __future__ import annotations

import importlib
import os
import time

import torch

from portbench.reference.encoder import Encoder, load_npz
from portbench.reference.tokenizer import Tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def checkpoint_dir(cfg: dict) -> str:
    return os.path.join(ROOT, cfg["encoder"]["checkpoint"])


def tokenizer(cfg: dict) -> Tokenizer:
    """The frozen tokenizer with the checkpoint's vocabulary."""
    vocab = os.path.join(checkpoint_dir(cfg), "tokenizer.vocab.txt")
    return Tokenizer(vocab if os.path.exists(vocab) else None,
                     int(cfg["vocab_size"]))


def reference_encoder(cfg: dict, device, matmul_dtype=torch.float32):
    """The plain float32 encoder and the frozen tokenizer for ``cfg``."""
    tok = tokenizer(cfg)
    model = Encoder(load_npz(os.path.join(checkpoint_dir(cfg),
                                          cfg["encoder"]["params"])),
                    int(cfg["num_hidden_layers"]),
                    int(cfg["num_attention_heads"]), device, matmul_dtype)
    return model, tok


def make_corpus(cfg: dict, seed: int, device):
    """The configuration's corpus generator, with its base rows made."""
    spec = cfg["corpus"]
    mod = importlib.import_module(f"portbench.corpus.{spec['generator']}")
    base = None
    if spec.get("base") == "qa_docs":
        # The chunks' embeddings by the benchmark's own float32 encoder,
        # made once and kept as a file (``corpus/qa_docs_rows.py``).
        from portbench.corpus import qa_docs_rows
        base = qa_docs_rows.load(device)
    return mod.Corpus(spec, seed, device, base_rows=base)


class System:
    def __init__(self, cfg: dict, seed: int, device, spans):
        from optimized_rag_tpu_torch.index.dense import DenseIndex
        self.cfg = cfg
        self.spans = spans
        self.device = torch.device(device)
        self.phases = {}      # seconds of each step of set-up
        t = time.perf_counter()
        self.corpus = make_corpus(cfg, seed, self.device)
        self.phases["corpus"] = time.perf_counter() - t
        t = time.perf_counter()
        ix = cfg["index"]
        self.index = DenseIndex(int(ix["dim"]), int(ix["capacity_block"]),
                                ix["dtype"], int(ix["tile"]),
                                device=self.device)
        for _, rows in self.corpus.blocks():
            self.index.add(rows)
        self.n_rows = self.index.size
        self._sync()
        self.phases["fill"] = time.perf_counter() - t
        t = time.perf_counter()
        self.search_index = spans.wrap_index(self.index)
        self.svc = self.server = self.embed_fn = None
        if cfg.get("encoder"):
            from optimized_rag_tpu_torch.models.convert import load_biencoder
            self.svc = load_biencoder(checkpoint_dir(cfg), device=self.device,
                                      cache_size=int(
                                          cfg["encoder"]["cache_size"]))
            self.embed_fn = spans.wrap_encode(self.svc.encode)
        if cfg.get("server"):
            from optimized_rag_tpu_torch.serving import QueryServer
            sv = cfg["server"]
            self.server = QueryServer(
                self.embed_fn, self.search_index,
                max_batch=int(sv["max_batch"]),
                max_wait_ms=float(sv["max_wait_ms"]),
                max_k=int(sv["max_k"]), workers=int(sv["workers"]))
        self.phases["encoder"] = time.perf_counter() - t

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Stops the server and frees the program's device state."""
        if self.server is not None:
            self.server.stop()
        self.server = self.svc = self.embed_fn = None
        self.index = self.search_index = None
        self._sync()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
