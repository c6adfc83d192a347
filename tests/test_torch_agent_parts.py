"""The parts around the PyTorch port's RAGAgent against the JAX package's,
on the CPU: the synthetic dataset and its retrieval metrics, the RAGAS
metrics, document ingestion, checkpoint discovery, index snapshots of a
whole agent (within the port and across the packages), the agent's device
and the index policy's limits.

``make_dataset`` and the metrics are numpy in both packages: their outputs
are equal exactly. Ingestion runs the fake embedder of ``tests/fakes.py``:
chunk ids, texts, documents and KG triples are equal. The pretrained
encoder found by ``find_checkpoint_dir`` embeds within cosine 0.9999 of the
JAX package's, as in ``tests/test_torch_encoder.py``.
"""

import os
import time

import numpy as np
import pytest
import torch

import optimized_rag_tpu.native as jax_native
from optimized_rag_tpu.agent.agent import RAGAgent as JaxAgent
from optimized_rag_tpu.agent.llm import DeterministicLLM as JaxLLM
from optimized_rag_tpu.agent.web import WebSearchTool as JaxWeb
from optimized_rag_tpu.config import Settings as JaxSettings
from optimized_rag_tpu.eval import metrics as j_metrics
from optimized_rag_tpu.eval import synthetic as j_synthetic
from optimized_rag_tpu.models import pretrain as j_pretrain
from optimized_rag_tpu.models.encoder import EmbeddingService as JaxEmbed
from optimized_rag_tpu_torch import native
from optimized_rag_tpu_torch.agent.agent import RAGAgent
from optimized_rag_tpu_torch.agent.llm import DeterministicLLM
from optimized_rag_tpu_torch.agent.web import WebSearchTool
from optimized_rag_tpu_torch.config import Settings
from optimized_rag_tpu_torch.eval import metrics, synthetic
from optimized_rag_tpu_torch.models import convert, pretrain
from optimized_rag_tpu_torch.models.encoder import (
    EmbeddingService, TransformerConfig)

from fakes import FakeCrossEncoder, FakeEmbedder

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "pretrained")
QA_DOCS = os.path.join(REPO, "optimized_rag_tpu", "eval", "qa_docs")
NOW = 1_790_000_000.0
MIN_COSINE = 0.9999
TEXTS = ["How does the dense index handle deletes?",
         "Hybrid retrieval blends dense semantic scores with BM25.",
         "The Meridian project was led by Dr. Alvarez.",
         "qual é a função do MXU?"]


@pytest.fixture(autouse=True)
def hermetic(monkeypatch):
    """``time.time`` pinned; both packages' analyzers on their Python
    paths."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_load_attempted", True)
    for name in ("term_counts", "model_tokenize", "vocab_tokenize"):
        monkeypatch.setattr(native, name, lambda *args: None)


def _agent(pkg, tmp_path, settings=None):
    """A RAGAgent of ``pkg`` ("jax" or "port") on the fake embedder."""
    jax = pkg == "jax"
    s = settings or (JaxSettings() if jax else Settings())
    s.data_dir = str(tmp_path / pkg)
    llm, web = (JaxLLM, JaxWeb) if jax else (DeterministicLLM, WebSearchTool)
    return (JaxAgent if jax else RAGAgent)(
        s, llm=llm(), embed_service=FakeEmbedder(dim=32),
        cross_encoder=FakeCrossEncoder(),
        web=web(search_fn=lambda q, n: []),
        **({} if jax else {"device": "cpu"}))


# ------------------------------------------------- eval/synthetic.py

@pytest.mark.parametrize("seed, kw", [
    (0, {}),
    (11, dict(num_docs=128, num_topics=10, num_queries=20)),
    (1234, dict(num_docs=600, num_topics=30, num_queries=1))])
def test_make_dataset_equals_jax(seed, kw):
    got = synthetic.make_dataset(seed=seed, **kw)
    want = j_synthetic.make_dataset(seed=seed, **kw)
    assert got.texts == want.texts and got.queries == want.queries
    np.testing.assert_array_equal(got.doc_topics, want.doc_topics)
    np.testing.assert_array_equal(got.query_topics, want.query_topics)
    assert got.relevant == want.relevant
    assert got.num_docs == want.num_docs


def test_evaluate_retriever_and_ir_metrics_equal_jax():
    ds = synthetic.make_dataset(num_docs=64, num_topics=4, num_queries=8,
                                seed=5)
    rng = np.random.default_rng(0)
    ranked = {q: rng.permutation(64)[:10].tolist() for q in ds.queries}
    retrieve = lambda q, k: ranked[q][:k]        # noqa: E731
    for k in (1, 5, 10):
        assert synthetic.evaluate_retriever(retrieve, ds, k) == \
            j_synthetic.evaluate_retriever(retrieve, ds, k)
    got = np.asarray([ranked[q] for q in ds.queries])
    grades = [{int(d): float(1 + d % 3) for d in sorted(rel)[:6]}
              for rel in ds.relevant]
    np.testing.assert_array_equal(metrics.ndcg_at_k(got, grades, 10),
                                  j_metrics.ndcg_at_k(got, grades, 10))
    assert metrics.RAGEvaluator().evaluate_retrieval(got, ds.relevant) == \
        j_metrics.RAGEvaluator().evaluate_retrieval(got, ds.relevant)
    assert metrics.RAGEvaluator(DeterministicLLM()).faithfulness_score(
        "The TPU has a systolic array.", "The TPU has a systolic array.") \
        == j_metrics.RAGEvaluator(JaxLLM()).faithfulness_score(
            "The TPU has a systolic array.", "The TPU has a systolic array.")


# --------------------------------------------------- eval/metrics.py

def _toy_embed(texts):
    """tests/test_eval_utils.py's toy space: words hashed to 16 dims."""
    out = np.zeros((len(texts), 16), np.float32)
    for i, t in enumerate(texts):
        for w in t.lower().split():
            out[i, hash(w) % 16] += 1.0
    return out


RAGAS_CASES = {
    "supported": dict(
        question="what is the matrix unit size",
        answer="The matrix unit size is 128 by 128.",
        contexts=["The matrix unit is a systolic array of size 128 by "
                  "128 that multiplies matrices.",
                  "Bananas are yellow fruits grown in the tropics."],
        ground_truth="The matrix unit size is 128 by 128."),
    "unsupported": dict(
        question="what is the matrix unit size",
        answer="It costs four hundred dollars per month wholesale.",
        contexts=["The matrix unit is a systolic array."]),
    "no_contexts": dict(question="q", answer="An answer with some words.",
                        contexts=[]),
}


@pytest.mark.parametrize("case", sorted(RAGAS_CASES))
def test_native_ragas_metrics_equal_jax(case):
    row = RAGAS_CASES[case]
    got = metrics.NativeRAGASEvaluator(_toy_embed).evaluate_rag_response(
        **row)
    want = j_metrics.NativeRAGASEvaluator(_toy_embed).evaluate_rag_response(
        **row)
    assert got == want
    rows = [dict(row, ground_truth=row.get("ground_truth"))]
    assert metrics.NativeRAGASEvaluator(_toy_embed).evaluate_batch(rows) \
        == j_metrics.NativeRAGASEvaluator(_toy_embed).evaluate_batch(rows)


def test_ragas_facade_equals_jax():
    embed = lambda ts: np.ones((len(ts), 4), np.float32)   # noqa: E731
    args = ("q", "an answer about things here",
            ["an answer about things here"])
    got = metrics.RAGASEvaluator(embed_fn=embed)
    want = j_metrics.RAGASEvaluator(embed_fn=embed)
    assert got.available == want.available
    assert got.evaluate_rag_response(*args) == \
        want.evaluate_rag_response(*args)
    assert metrics.RAGASEvaluator().evaluate_rag_response(*args) is None \
        and j_metrics.RAGASEvaluator().evaluate_rag_response(*args) is None


# ------------------------------------------------- services/ingest.py

def _store_rows(agent):
    st = agent.store
    return (st.execute("SELECT id, document_id, content, chunk_index, "
                       "metadata FROM chunks ORDER BY id"),
            st.execute("SELECT id, filename, title, metadata, quality FROM "
                       "documents ORDER BY id"),
            st.execute("SELECT subject, relation, object, source_doc FROM "
                       "kg_triples ORDER BY id"))


@pytest.mark.parametrize("strategy", ["recursive", "fixed", "semantic"])
def test_ingest_text_and_upload_directory_equal_jax(tmp_path, strategy):
    out = {}
    for pkg in ("jax", "port"):
        s = JaxSettings() if pkg == "jax" else Settings()
        s.chunking.strategy = strategy
        a = _agent(pkg, tmp_path, s)
        strip = lambda r: {k: v for k, v in r.items()   # noqa: E731
                           if k != "seconds"}
        results = [strip(a.ingestor.ingest_text(
            "The Meridian project was led by Dr. Alvarez. " * 30,
            filename="m.txt", title="Meridian")),
            strip(a.ingestor.ingest_text("   ", filename="empty.txt"))]
        results += [strip(r) for r in a.ingestor.upload_directory(QA_DOCS)]
        out[pkg] = (results, _store_rows(a), a.dense.size, a.lexical.size,
                    a.dense.vectors_f32().cpu().numpy()
                    if pkg == "port" else np.asarray(a.dense.vectors_f32()),
                    a.maybe_upgrade_index(), a.ingestor.list_documents())
    (r_p, rows_p, n_p, lex_p, emb_p, kind_p, docs_p) = out["port"]
    (r_j, rows_j, n_j, lex_j, emb_j, kind_j, docs_j) = out["jax"]
    assert r_p == r_j and rows_p == rows_j and docs_p == docs_j
    assert (n_p, lex_p, kind_p) == (n_j, lex_j, kind_j) == (
        n_p, n_p, "dense")
    assert len(rows_p[2]) > 0          # KG triples were extracted
    np.testing.assert_allclose(emb_p, emb_j, atol=1e-6)


# ------------------------------------- models/pretrain.py (discovery)

def test_find_checkpoint_dir_search_order(tmp_path):
    for data_dir in (str(tmp_path), str(tmp_path / "missing")):
        got = pretrain.find_checkpoint_dir(data_dir)
        assert got == j_pretrain.find_checkpoint_dir(data_dir)
        assert os.path.realpath(got) == os.path.realpath(CKPT)
    models = tmp_path / "models"
    models.mkdir()
    (models / "biencoder.params.npz").symlink_to(
        os.path.join(CKPT, "biencoder.params.npz"))
    assert pretrain.find_checkpoint_dir(str(tmp_path)) == \
        j_pretrain.find_checkpoint_dir(str(tmp_path)) == str(models)
    assert pretrain.load_pretrained(str(tmp_path), "biencoder") is None
    assert j_pretrain.load_pretrained(str(tmp_path), "biencoder") is None


def test_load_pretrained_and_tokenizer_match_jax():
    """The checkpoint the agent finds: the same configuration as the JAX
    package reads, the state dict ``convert`` gives, the same token ids,
    and embeddings within cosine 0.9999 of the JAX package's."""
    ckpt = pretrain.find_checkpoint_dir(os.path.join(REPO, "nowhere"))
    for name in ("biencoder", "crossencoder"):
        cfg, state = pretrain.load_pretrained(ckpt, name)
        j_cfg, _ = j_pretrain.load_pretrained(ckpt, name)
        for f in ("vocab_size", "hidden_dim", "num_layers", "num_heads",
                  "mlp_dim", "max_seq_len", "num_types", "out_dim"):
            assert getattr(cfg, f) == getattr(j_cfg, f)
        assert cfg.dtype == torch.bfloat16 and str(j_cfg.dtype) == \
            "<class 'jax.numpy.bfloat16'>"
        ref = convert.flax_to_torch(convert.load_params(ckpt, name), cfg)
        assert state.keys() == ref.keys()
        assert all(torch.equal(state[k], ref[k]) for k in state)
    with pytest.raises(NotImplementedError, match="item 9"):
        pretrain.load_pretrained(ckpt, "decoder")
    for d, v, n in ((ckpt, 32768, 128), (None, 32768, 128), (None, 512, 32)):
        tok, j_tok = (pretrain.load_tokenizer(d, v, n),
                      j_pretrain.load_tokenizer(d, v, n))
        assert type(tok).__name__ == type(j_tok).__name__
        for a, b in zip(tok.encode_batch(TEXTS, n),
                        j_tok.encode_batch(TEXTS, n)):
            np.testing.assert_array_equal(a, b)
    cfg, state = pretrain.load_pretrained(ckpt, "biencoder")
    port = EmbeddingService(cfg, params=state, max_len=128, cache_size=0,
                            tokenizer=pretrain.load_tokenizer(
                                ckpt, cfg.vocab_size, 128), device="cpu")
    j_cfg, params = j_pretrain.load_pretrained(ckpt, "biencoder")
    ref = JaxEmbed(j_cfg, params=params, max_len=128, cache_size=0,
                   tokenizer=j_pretrain.load_tokenizer(ckpt, j_cfg.vocab_size,
                                                       128))
    cos = np.sum(port.encode(TEXTS) * ref.encode(TEXTS), axis=1)
    assert cos.min() >= MIN_COSINE, cos.min()


def test_agent_loads_the_found_checkpoints(tmp_path):
    s = Settings()
    s.data_dir = str(tmp_path)
    a = RAGAgent(s, llm=DeterministicLLM(), device="cpu",
                 web=WebSearchTool(search_fn=lambda q, n: []))
    assert isinstance(a.embedder.cfg, TransformerConfig)
    assert (a.embedder.cfg.num_layers, a.embedder.max_len,
            a.cross_encoder.max_len) == (6, 128, 128)
    assert a.embedder.tokenizer.__class__.__name__ == "VocabTokenizer"
    assert a.retriever.encoder is a.embedder and a.fused_eval is not None
    assert a.device.type == a.dense.device.type == "cpu"


# ------------------------------------------ save_indexes / load_indexes

def _filled(pkg, tmp_path, name):
    a = _agent(pkg, tmp_path / name)
    for text in ("The TPU is a matrix accelerator with a systolic array of "
                 "128x128 multiply accumulate units.",
                 "PostgreSQL is a relational database. The pgvector "
                 "extension has HNSW indexes."):
        a.ingestor.ingest_text(text)
    a.memory.archival_memory_insert("the user prefers systolic arrays")
    return a


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_save_then_load_indexes_answers_the_same_turn(tmp_path, saver):
    """An agent whose indexes are restored from another agent's snapshot
    (saved by the port, or by the JAX package) answers as that agent
    does: the restored indexes replace its own, on its device."""
    src = _filled(saver, tmp_path, "src")
    directory = src.save_indexes()
    assert directory == os.path.join(src.settings.data_dir, "indexes")
    dst = _filled("port", tmp_path, "dst")
    fresh = _agent("port", tmp_path / "fresh")
    assert fresh.load_indexes(str(tmp_path / "none")) is False
    own = dst.dense
    assert dst.load_indexes(directory) is True
    assert dst.dense is not own and dst.retriever.dense is dst.dense
    assert dst.retriever.lexical is dst.lexical
    assert dst.dense.device.type == dst.lexical.device.type == \
        dst.memory.archival.device.type == "cpu"
    assert (dst.dense.size, dst.lexical.size, dst.memory.archival.size) == \
        (src.dense.size, src.lexical.size, src.memory.archival.size)
    for q in ("What is the TPU systolic array?",
              "what does the user prefer about arrays?"):
        trace_s, trace_d = [], []
        rs, rd = src.chat(q, trace=trace_s), dst.chat(q, trace=trace_d)
        assert (rd.answer, rd.citations, rd.refused, trace_d) == \
            (rs.answer, rs.citations, rs.refused, trace_s)
        assert [(s["doc_id"], s["source"]) for s in rd.sources] == \
            [(s["doc_id"], s["source"]) for s in rs.sources]
        np.testing.assert_allclose([s["score"] for s in rd.sources],
                                   [s["score"] for s in rs.sources],
                                   atol=1e-5)


def test_port_snapshot_loads_into_the_jax_agent(tmp_path):
    src = _filled("port", tmp_path, "src")
    dst = _filled("jax", tmp_path, "dst")
    assert dst.load_indexes(src.save_indexes()) is True
    q = "What is the TPU systolic array?"
    rs, rd = src.chat(q), dst.chat(q)
    assert (rd.answer, rd.citations, [s["doc_id"] for s in rd.sources]) == \
        (rs.answer, rs.citations, [s["doc_id"] for s in rs.sources])


# --------------------------------------------- device and index policy

def test_agent_defaults_to_cuda_and_raises_without_a_card(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = Settings()
    s.data_dir = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RAGAgent(s, llm=DeterministicLLM(),
                 embed_service=FakeEmbedder(dim=32),
                 cross_encoder=FakeCrossEncoder(),
                 web=WebSearchTool(search_fn=lambda q, n: []))
    a = _agent("port", tmp_path)
    for dev in (a.dense.device, a.lexical.device, a.memory.archival.device,
                a.consistency.device, a.reranker.device, a.selfrag.device,
                a.ensemble.device, a.intent_recognizer.detector.device):
        assert dev.type == "cpu"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_corpus_dtype_reaches_the_dense_index(tmp_path, dtype):
    got = {}
    for pkg in ("jax", "port"):
        s = JaxSettings() if pkg == "jax" else Settings()
        s.retrieval.corpus_dtype = dtype
        a = _agent(pkg, tmp_path, s)
        a.ingestor.ingest_text("The TPU is a matrix accelerator. The MXU "
                               "multiplies matrices in bfloat16.")
        a.ingestor.ingest_text("PostgreSQL has HNSW indexes for vectors.")
        r = a.chat("what does the MXU multiply?")
        got[pkg] = (r.answer, r.citations, r.refused,
                    [s_["doc_id"] for s_ in r.sources])
        if pkg == "port":
            assert a.dense.dtype == getattr(torch, dtype)
    assert got["port"] == got["jax"]


def test_upgrade_past_ivf_min_size_raises_item_7(tmp_path):
    """Past ``ivf_min_size`` the policy asks for IVF, which the port does
    not have yet: the upgrade raises, and so does the ingest that calls it,
    where the JAX package builds an IVF overlay."""
    out = {}
    for pkg in ("jax", "port"):
        a = _agent(pkg, tmp_path)
        a.ingestor.ingest_text(" ".join(
            f"Sentence {i} says the corpus grows." for i in range(60)))
        assert a.maybe_upgrade_index() == "dense"
        a.settings.ivf.ivf_min_size = a.dense.size
        if pkg == "jax":
            out[pkg] = a.maybe_upgrade_index()
            continue
        with pytest.raises(NotImplementedError, match="item 7"):
            a.maybe_upgrade_index()
        with pytest.raises(NotImplementedError, match="item 7"):
            a.ingestor.ingest_text("One more document past the limit.")
        a.settings.mesh.data_parallel = 2
        with pytest.raises(NotImplementedError, match="item 8"):
            a.maybe_upgrade_index()
    assert out["jax"] == "ivf"
