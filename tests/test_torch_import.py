"""The PyTorch port stands alone: no JAX, no Flax, no JAX package, and
entry points that run on CUDA unless asked for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import optimized_rag_tpu_torch
from optimized_rag_tpu_torch import cli, native
from optimized_rag_tpu_torch.agent.agent import RAGAgent
from optimized_rag_tpu_torch.agent.rewriter import (
    ConversationReferenceDetector)
from optimized_rag_tpu_torch.agent.verification import (
    ClaimAlignmentScorer, EnsembleVerifier, SelfRAGEvaluator)
from optimized_rag_tpu_torch.config import Settings
from optimized_rag_tpu_torch.engine.consistency import ConsistencyChecker
from optimized_rag_tpu_torch.engine.rerank import SelectiveReranker
from optimized_rag_tpu_torch.engine.wrangler import (
    DataWrangler, Deduplicator)
from optimized_rag_tpu_torch.eval import (
    encoder_gauntlet, holdout_probes, qa_sheet)
from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.index.ivf import IVFIndex
from optimized_rag_tpu_torch.index.lexical import LexicalIndex
from optimized_rag_tpu_torch.index.policy import build_index_for
from optimized_rag_tpu_torch.models.convert import (
    load_biencoder, load_crossencoder)
from optimized_rag_tpu_torch.index.policy import mesh_or_none
from optimized_rag_tpu_torch.models.decoder import DecoderConfig, Generator
from optimized_rag_tpu_torch.models.encoder import (
    CrossEncoderService, EmbeddingService, TransformerConfig)
from optimized_rag_tpu_torch.models.grounded import (
    GroundedConfig, GroundedGenerator)
from optimized_rag_tpu_torch.models import pretrain
from optimized_rag_tpu_torch.parallel.mesh import (
    make_mesh, make_multihost_mesh)
from optimized_rag_tpu_torch.store.db import MetadataStore
from optimized_rag_tpu_torch.store.memory import MemoryManager
from optimized_rag_tpu_torch.utils.health import check_device_health

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(optimized_rag_tpu_torch.__file__)
FORBIDDEN = ("jax", "flax", "optax", "orbax", "chex", "optimized_rag_tpu")


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="optimized_rag_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_submodules()!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert len(_submodules()) >= 94
    for m in ("parallel.mesh", "parallel.sharded_topk", "parallel.sharded_ivf",
              "models.decoder", "models.grounded", "models.training",
              "models.loader", "models.grounded_data", "models.corpus",
              "models.xlingual", "eval.llm_endpoint", "store.checkpoint",
              "eval.qa_sheet", "eval.holdout_probes", "eval.kg_eval",
              "eval.encoder_gauntlet"):
        assert f"optimized_rag_tpu_torch.{m}" in _submodules()


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, (path, bad)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    embed = lambda texts: torch.ones(len(texts), 16).numpy()  # noqa: E731
    tiny = TransformerConfig(vocab_size=64, hidden_dim=16, num_layers=1,
                             num_heads=2, mlp_dim=32, max_seq_len=16,
                             out_dim=8)
    ckpt = os.path.join(REPO, "checkpoints", "pretrained")
    tiny_service = EmbeddingService(tiny, device="cpu")
    tiny_lm = DecoderConfig(hidden_dim=16, num_layers=1, num_heads=2,
                            mlp_dim=32, max_seq_len=64)
    tiny_grounded = GroundedConfig(hidden_dim=16, num_layers=1, num_heads=2,
                                   mlp_dim=32, max_seq_len=64, copy_dim=8)
    dp2 = Settings()
    dp2.mesh.data_parallel = 2
    for make in (lambda: DenseIndex(16, 256, tile=256),
                 lambda: EmbeddingService(tiny),
                 lambda: load_biencoder(ckpt),
                 lambda: LexicalIndex(),
                 lambda: CrossEncoderService(tiny),
                 lambda: load_crossencoder(ckpt),
                 lambda: SelectiveReranker(),
                 lambda: MemoryManager(MetadataStore(":memory:"), embed),
                 lambda: ConsistencyChecker(embed),
                 lambda: Deduplicator(embed_fn=embed),
                 lambda: DataWrangler(embed_fn=embed),
                 lambda: build_index_for("dense", 16, Settings()),
                 lambda: IVFIndex(),
                 lambda: build_index_for("ivf", 16, Settings()),
                 lambda: cli.build_agent(Settings()),
                 lambda: ConversationReferenceDetector(embed),
                 lambda: EnsembleVerifier(None, embed),
                 lambda: SelfRAGEvaluator(None, embed),
                 lambda: ClaimAlignmentScorer(embed),
                 lambda: RAGAgent(Settings(), embed_service=tiny_service,
                                  cross_encoder=object()),
                 lambda: make_mesh(data=2),
                 lambda: make_multihost_mesh(),
                 lambda: mesh_or_none(dp2),
                 lambda: Generator(tiny_lm, max_prompt_len=32,
                                   max_new_tokens=8),
                 lambda: GroundedGenerator(tiny_grounded, max_prompt_len=32,
                                           max_new_tokens=8),
                 lambda: cli._local_lm_provider(Settings()),
                 lambda: pretrain.default_mesh(),
                 lambda: pretrain.pretrain_all(
                     "unused", ["a b c"], encoder_cfg=tiny, cross_cfg=tiny),
                 lambda: pretrain.train_biencoder(["a b c"], tiny),
                 lambda: pretrain.train_cross_encoder(["a b c"], tiny),
                 lambda: pretrain.train_decoder(["a b c"], tiny_lm),
                 lambda: pretrain.train_grounded(["a b c"], tiny_grounded),
                 lambda: cli.main(["train", "--steps", "1"]),
                 lambda: qa_sheet.main(["--no-pt"]),
                 lambda: holdout_probes.main([]),
                 lambda: encoder_gauntlet.run_gauntlet()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    report = check_device_health(timeout_s=60, matmul_dim=8)
    assert report["healthy"] is False
    assert "CUDA is not available" in report["error"]
    assert DenseIndex(16, 256, tile=256, device="cpu").device.type == "cpu"
    assert IVFIndex(device="cpu").device.type == "cpu"
    assert build_index_for("ivf", 16, Settings(),
                           device="cpu").device.type == "cpu"
    assert MemoryManager(MetadataStore(":memory:"), embed, embed_dim=16,
                         device="cpu").archival.device.type == "cpu"
    assert ConsistencyChecker(embed, device="cpu").device.type == "cpu"
    assert check_device_health(matmul_dim=8, device="cpu")["healthy"]
    assert LexicalIndex(device="cpu").device.type == "cpu"
    assert mesh_or_none(dp2, "cpu").devices[0, 0].type == "cpu"
    assert Generator(tiny_lm, max_prompt_len=32, max_new_tokens=8,
                     device="cpu").device.type == "cpu"
    assert CrossEncoderService(tiny, device="cpu").device.type == "cpu"


def test_native_library_is_built_under_build_never_native():
    path = os.path.realpath(native.library_path())
    build = os.path.realpath(os.path.join(REPO, "build")) + os.sep
    assert path.startswith(build), path
    assert not path.startswith(os.path.realpath(os.path.join(
        REPO, "native")) + os.sep)
    assert os.path.realpath(native.SOURCE) == os.path.realpath(
        os.path.join(REPO, "native", "analyzer.cpp"))
    lib = native.load_library()
    assert os.path.realpath(lib._name) == path
    assert "-march=native" not in native.CXX_FLAGS


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
