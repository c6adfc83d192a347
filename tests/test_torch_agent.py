"""RAGAgent of the PyTorch port against the JAX package's, on the CPU.

Both packages' agents run the same turns from the same inputs, with the
port at ``device="cpu"``, in three setups:

* the hermetic fixture of ``tests/test_agent.py`` (``FakeEmbedder(dim=64)``,
  ``FakeCrossEncoder``, two documents, ``enable_kg=True``): every field of
  every ``ChatResponse`` is equal (answer, citations, sources, refused,
  intent, tiers_used, warnings, the node trace), its scores within 1e-5;
* the tiny seeded models of ``tests/test_fused_agent_parity.py``, the JAX
  services' parameters carried into the port by ``flax_to_torch``: the
  port's fused turn equals its modular turn field for field, and both equal
  the JAX package's turns;
* one session over ``optimized_rag_tpu/eval/qa_docs/`` with the in-repo
  checkpoints: answers, citations, refusals, intents and traces equal.

Then the node-level cases of ``tests/test_nodes_unit.py`` and
``tests/test_embed_rescue.py``, one parametrised test per oracle file.

A cosine that feeds a threshold (the ensemble's embedding vote, Self-RAG's
sufficiency, the reference detector's near-duplicate rule) may sit within
1e-6 of it, where the two packages' float32 sums may decide differently:
such a turn is counted and excused, and its session compared no further.
``time.time`` is pinned, and both packages' analyzers run their Python
paths (the JAX package takes its C++ path only where its library happens
to be built).
"""

import os
import time
import types
import unittest.mock as mock

import numpy as np
import pytest
import torch

import optimized_rag_tpu.native as jax_native
from optimized_rag_tpu.agent import prompts as j_prompts
from optimized_rag_tpu.agent.agent import RAGAgent as JaxAgent
from optimized_rag_tpu.agent.llm import DeterministicLLM as JaxLLM
from optimized_rag_tpu.agent.nodes import core as j_core
from optimized_rag_tpu.agent.state import AgentState as JaxState
from optimized_rag_tpu.agent.verification import (
    EnsembleVerifier as JaxEnsemble)
from optimized_rag_tpu.agent.web import WebSearchTool as JaxWeb
from optimized_rag_tpu.config import Settings as JaxSettings
from optimized_rag_tpu.engine import types as j_types
from optimized_rag_tpu.models.encoder import (
    CrossEncoderService as JaxCross, EmbeddingService as JaxEmbed,
    TransformerConfig as JaxConfig)
from optimized_rag_tpu.models.loader import _flatten
from optimized_rag_tpu_torch import native
from optimized_rag_tpu_torch.agent import prompts, rewriter, verification
from optimized_rag_tpu_torch.agent.agent import RAGAgent
from optimized_rag_tpu_torch.agent.llm import DeterministicLLM
from optimized_rag_tpu_torch.agent.nodes import core
from optimized_rag_tpu_torch.agent.state import AgentState
from optimized_rag_tpu_torch.agent.verification import EnsembleVerifier
from optimized_rag_tpu_torch.agent.web import WebSearchTool
from optimized_rag_tpu_torch.config import Settings
from optimized_rag_tpu_torch.engine import types as p_types
from optimized_rag_tpu_torch.models.convert import flax_to_torch
from optimized_rag_tpu_torch.models.encoder import (
    CrossEncoderService, EmbeddingService, TransformerConfig)

from fakes import FakeCrossEncoder, FakeEmbedder
from test_embed_rescue import DOCS as RESCUE_DOCS, FILLER, VocabEmbed

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QA_DOCS = os.path.join(REPO, "optimized_rag_tpu", "eval", "qa_docs")
NOW = 1_790_000_000.0
SCORE_TOL = 1e-5          # the fakes: the same float32 host arithmetic
FUSED = 1e-4              # a fused score after an encoder forward
# A reranked source's score blends 0.7 of sigmoid(logit); the bf16
# cross-encoder's logits agree within 0.35 (tests/test_torch_rerank.py)
# and the sigmoid's slope is at most 1/4.
RERANKED = 0.35 / 4
THRESHOLD_TIE = 1e-6      # chip_smoke.py's: a cosine this near a threshold

JAX = types.SimpleNamespace(
    name="jax", Agent=JaxAgent, LLM=JaxLLM, Web=JaxWeb, Settings=JaxSettings,
    State=JaxState, core=j_core, types=j_types, prompts=j_prompts,
    Ensemble=JaxEnsemble, kw={})
PORT = types.SimpleNamespace(
    name="port", Agent=RAGAgent, LLM=DeterministicLLM, Web=WebSearchTool,
    Settings=Settings, State=AgentState, core=core, types=p_types,
    prompts=prompts, Ensemble=EnsembleVerifier, kw={"device": "cpu"})

DOC_TPU = ("The TPU is a matrix accelerator. The TPU has a systolic array "
           "with 128x128 multiply accumulate units. The MXU performs "
           "matrix multiplication in bfloat16 precision.")
DOC_PG = ("PostgreSQL is a relational database. The pgvector extension "
          "has HNSW indexes. HNSW uses hierarchical navigable small worlds.")
Q_TPU = "What is the TPU systolic array?"


def _pin(mp):
    """``time.time`` pinned; both packages' analyzers on their Python
    paths (the port's native entry points decline every text)."""
    mp.setattr(time, "time", lambda: NOW)
    mp.setattr(jax_native, "_lib", None)
    mp.setattr(jax_native, "_load_attempted", True)
    for name in ("term_counts", "model_tokenize", "vocab_tokenize"):
        mp.setattr(native, name, lambda *args: None)


def _spy_cosines(mp):
    """Every cosine the port's rewriter and verifiers compute goes into
    the returned list."""
    seen, cosine_matrix = [], verification.cosine_matrix

    def spy(a, b):
        out = cosine_matrix(a, b)
        seen.extend(out.flatten().tolist())
        return out
    for mod in (verification, rewriter):
        mp.setattr(mod, "cosine_matrix", spy)
    return seen


@pytest.fixture(autouse=True)
def hermetic(monkeypatch):
    _pin(monkeypatch)


@pytest.fixture
def cosines(monkeypatch):
    return _spy_cosines(monkeypatch)


def _thresholds(settings):
    """The cosine thresholds the turn's decisions read: the ensemble's
    embedding vote, the reference detector's two rules, Self-RAG's
    sufficiency (sims01 >= 0.5, i.e. cosine >= 0)."""
    return (settings.verification.embedding_verify_threshold, 0.75, 0.85,
            0.0)


def _threshold_ties(values, settings):
    v = np.asarray(values, np.float64)[:, None]
    return int((np.abs(v - np.asarray(_thresholds(settings))) <=
                THRESHOLD_TIE).any(axis=1).sum()) if len(values) else 0


def _settings(ns, tmp_path, kg=True):
    s = ns.Settings()
    s.data_dir = str(tmp_path / ns.name)
    s.flags.enable_kg = kg
    return s


def _fake_agent(ns, tmp_path, docs=(DOC_TPU, DOC_PG), web_fn=None,
                embed_dim=64, kg=True):
    a = ns.Agent(_settings(ns, tmp_path, kg), llm=ns.LLM(),
                 embed_service=FakeEmbedder(dim=embed_dim),
                 cross_encoder=FakeCrossEncoder(),
                 web=ns.Web(search_fn=web_fn or (lambda q, n: [])), **ns.kw)
    for text, (name, title) in zip(docs, (("tpu.txt", "TPU basics"),
                                          ("pg.txt", "Postgres"))):
        a.ingestor.ingest_text(text, filename=name, title=title)
    return a


EXACT = ("answer", "citations", "refused", "intent", "tiers_used",
         "hitl_flagged", "warnings", "factuality_level")
SCORES = ("confidence", "factuality_score", "support_ratio", "faithfulness",
          "uncertainty")


def _fields(resp, trace):
    """(exact fields, scores) of one ChatResponse."""
    exact = {f: getattr(resp, f) for f in EXACT}
    exact["trace"] = trace
    exact["sources"] = [(s["doc_id"], s["source"], s["tier"], s["text"])
                        for s in resp.sources]
    exact["metrics"] = {k: v for k, v in resp.metrics.items()
                        if k != "latency_s"}
    scores = [getattr(resp, f) for f in SCORES] + [s["score"]
                                                   for s in resp.sources]
    return exact, np.asarray(scores, np.float64)


def _session(ref, port, queries, seen, tol=SCORE_TOL):
    """Each query through both agents in order, every field held; a turn
    that differs must show a cosine within THRESHOLD_TIE of a threshold in
    the port's run, and ends the comparison. Returns (turns held, excused
    turns, the responses)."""
    held, out = 0, []
    for q in queries:
        del seen[:]
        tj, tp = [], []
        rj, rp = ref.chat(q, trace=tj), port.chat(q, trace=tp)
        out.append((rj, rp))
        (ej, sj), (ep, sp) = _fields(rj, tj), _fields(rp, tp)
        if ej != ep or sj.shape != sp.shape or \
                not np.allclose(sj, sp, atol=tol, rtol=0):
            assert _threshold_ties(seen, port.settings), (q, ej, ep, sj, sp)
            return held, 1, out
        held += 1
    return held, 0, out


# ------------------------------------------------- the hermetic fixture

SESSIONS = {
    "qa": [Q_TPU],
    "clarification": [Q_TPU, "what did I ask earlier?"],
    "comparison_cot": ["Compare the TPU and PostgreSQL approaches"],
    "mixed": [Q_TPU, "Compare the TPU and PostgreSQL approaches",
              "what did I ask earlier?", "tell me about hnsw indexes",
              "Is it true that HNSW uses navigable small worlds?"],
    "after_deep_warmup": [Q_TPU, "tell me about hnsw indexes"],
}


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_fake_fixture_turns_match_jax(tmp_path, cosines, name):
    ref, port = (_fake_agent(ns, tmp_path) for ns in (JAX, PORT))
    if name == "after_deep_warmup":
        assert ref.warmup(deep=True) >= 0 and port.warmup(deep=True) >= 0
    held, excused, _ = _session(ref, port, SESSIONS[name], cosines)
    if excused:
        return
    assert held == len(SESSIONS[name])
    # What the turns left behind: the conversation, DW-GRPO's window, the
    # KG triples of the ingest, the tools.
    assert port.memory.get_recent_messages(20) == \
        ref.memory.get_recent_messages(20)
    assert port.weight_manager.tracker.stats() == \
        ref.weight_manager.tracker.stats()
    for entity in ("tpu", "hnsw", "postgresql"):
        assert port.store.find_triples(port.settings.agent_id, entity) == \
            ref.store.find_triples(ref.settings.agent_id, entity)
    assert port.tools.specs() == ref.tools.specs()
    assert port.memory.get_core_memory() == ref.memory.get_core_memory()


@pytest.mark.parametrize("case", ["empty_index_refuses", "web_rescue"])
def test_fake_fixture_refusal_and_web_rescue_match_jax(tmp_path, cosines,
                                                      case):
    hits = {"jax": [], "port": []}

    def web(ns):
        def web_fn(q, n):
            hits[ns.name].append(q)
            return [{"title": "Answer", "content": "the answer is 42",
                     "url": ""}]
        return web_fn if case == "web_rescue" else None
    ref, port = (_fake_agent(ns, tmp_path, docs=(), web_fn=web(ns))
                 for ns in (JAX, PORT))
    held, excused, ((rj, rp),) = _session(
        ref, port, ["what is the answer to everything?"], cosines)
    assert held + excused == 1
    if excused:
        return
    assert hits["jax"] == hits["port"]
    if case == "web_rescue":
        assert not rp.refused and "42" in rp.answer
    else:
        assert rp.refused and rp.support_ratio == 0.0


def _web_recorder(hits):
    def web_fn(q, n):
        hits.append(q)
        return [{"title": "T", "content": f"web says {q}", "url": "u"}]
    return web_fn


def _broken_llm(ns):
    class BrokenLLM(ns.LLM):
        def structured(self, prompt, keys, task="", **kw):
            if task == "tier3_decision":
                raise RuntimeError("llm down")
            return super().structured(prompt, keys, task=task, **kw)
    return BrokenLLM()


TIER3 = {   # test_agent.py's tier-3 cases: (query, context score, llm)
    "sufficient_context": ("what is a tpu", 0.9, None),
    "low_scores": ("what is a tpu", 0.1, None),
    "recency": ("latest tpu announcements", 0.95, None),
    "conversation_guard": ("what was my first question?", None, None),
    "llm_failure": ("what is a tpu", None, _broken_llm),
}


@pytest.mark.parametrize("case", sorted(TIER3))
def test_tier3_agentic_search_matches_jax(tmp_path, case):
    query, score, llm = TIER3[case]
    got = {}
    for ns in (JAX, PORT):
        hits = []
        a = ns.Agent(_settings(ns, tmp_path, kg=True),
                     llm=llm(ns) if llm else ns.LLM(),
                     embed_service=FakeEmbedder(dim=64),
                     cross_encoder=FakeCrossEncoder(),
                     web=ns.Web(search_fn=_web_recorder(hits)), **ns.kw)
        ctx = None if score is None else [ns.types.RetrievedDoc(
            doc_id=0, score=score, text="a tpu is an accelerator")]
        out = a.tier3_agentic_search(query, existing_context=ctx)
        got[ns.name] = (hits, [(d.doc_id, d.score, d.text, d.source.value,
                                d.tier, d.metadata) for d in out])
    assert got["port"] == got["jax"]


# --------------------------------------------------- tiny seeded models

TINY = dict(vocab_size=1024, hidden_dim=64, num_layers=2, num_heads=4,
            mlp_dim=128, out_dim=32, max_seq_len=64)
TINY_DOCS = [
    "The TPU is a matrix accelerator built around a systolic array. "
    "Its MXU performs 128x128 multiply accumulate operations per cycle.",
    "Reranking depth interacts with context compression: deeper rerank "
    "pools improve precision while compression caps token budgets.",
    "Bananas grow in tropical climates and ripen after harvest.",
    "Hybrid retrieval blends dense semantic scores with BM25 keyword "
    "scores and a temporal recency decay per intent.",
]
TINY_QUERIES = ["What does the MXU do in a TPU?",
                "How does reranking interact with compression?"]


def _tiny_agent(ns, tmp_path, fused, embed, cross):
    s = ns.Settings()
    s.data_dir = str(tmp_path / f"{ns.name}-{fused}")
    s.flags.enable_fused_turn = fused
    s.retrieval.fuse_query_encoder = fused
    a = ns.Agent(s, llm=ns.LLM(), embed_service=embed, cross_encoder=cross,
                 web=ns.Web(search_fn=lambda q, n: []), **ns.kw)
    for i, t in enumerate(TINY_DOCS):
        a.ingestor.ingest_text(t, title=f"doc{i}")
    return a


def test_tiny_models_fused_and_modular_match_jax(tmp_path, cosines):
    """test_fused_agent_parity.py's agents: the port's fused turn equals
    its modular turn (as that test asks of the JAX package), and both equal
    the JAX package's fused turn."""
    je = JaxEmbed(JaxConfig(**TINY), seed=3, max_len=32)
    jc = JaxCross(JaxConfig(**TINY), seed=7, max_len=64)
    cfg = TransformerConfig(**TINY)
    ports = {fused: _tiny_agent(PORT, tmp_path, fused, EmbeddingService(
        cfg, params=flax_to_torch(_flatten(je.params), cfg), max_len=32,
        device="cpu"), CrossEncoderService(
        cfg, params=flax_to_torch(_flatten(jc.params), cfg), max_len=64,
        device="cpu")) for fused in (True, False)}
    assert ports[True].fused_eval is not None
    assert ports[True].retriever.encoder is not None
    assert ports[False].fused_eval is None
    assert ports[False].retriever.encoder is None
    turns = {}
    for fused, port in ports.items():
        ref = _tiny_agent(JAX, tmp_path / "jax", True, je, jc)
        held, excused, turns[fused] = _session(ref, port, TINY_QUERIES,
                                               cosines, tol=RERANKED)
        assert held == len(TINY_QUERIES) or excused
    for q, (_, rf), (_, rm) in zip(TINY_QUERIES, turns[True], turns[False]):
        assert rf.answer == rm.answer, q
        assert rf.citations == rm.citations
        assert [s["doc_id"] for s in rf.sources] == \
               [s["doc_id"] for s in rm.sources]
        for f in ("factuality_score", "support_ratio", "confidence"):
            np.testing.assert_allclose(getattr(rf, f), getattr(rm, f),
                                       atol=FUSED)
        assert rf.refused == rm.refused
        assert rf.tiers_used == rm.tiers_used


# -------------------------------- the in-repo checkpoints over qa_docs

QA_SESSION = [
    "What is the default chunk size and overlap?",
    "Who led the Meridian project and then where did they come from?",
    "What did I ask earlier?",
    "What did the framework's cloud bill cost in March?",
]


@pytest.fixture(scope="module")
def qa_session(tmp_path_factory):
    """One session of both agents (the pretrained encoders that
    ``find_checkpoint_dir`` finds, ``Settings()`` defaults) over the
    qa_docs upload. Returns the upload results, the turns and the port
    agent."""
    tmp = tmp_path_factory.mktemp("qa")
    with pytest.MonkeyPatch.context() as mp:
        _pin(mp)
        seen = _spy_cosines(mp)
        agents, uploads = [], []
        for ns in (JAX, PORT):
            s = ns.Settings()
            s.data_dir = str(tmp / ns.name)
            a = ns.Agent(s, llm=ns.LLM(),
                         web=ns.Web(search_fn=lambda q, n: []), **ns.kw)
            uploads.append(a.ingestor.upload_directory(QA_DOCS))
            agents.append(a)
        held, excused, turns = _session(*agents, QA_SESSION, seen,
                                        tol=RERANKED)
    return uploads, held, excused, turns, agents[1]


def test_qa_docs_session_matches_jax(qa_session):
    uploads, held, excused, turns, port = qa_session
    assert held + excused == len(QA_SESSION)
    strip = lambda rs: [{k: v for k, v in r.items() if k != "seconds"}
                        for r in rs]
    assert strip(uploads[1]) == strip(uploads[0])
    assert port.embedder.cfg.num_layers == 6
    assert port.fused_eval is not None and port.retriever.encoder is not None
    if excused:
        return
    (qa, _), (hop, _), (recall, _), (refusal, _) = turns
    assert not qa.refused and "1200" in qa.answer and qa.citations
    assert hop.intent == "multi_hop_reasoning" and "basel" in \
        hop.answer.lower() and any(s["doc_id"] == -2 for s in hop.sources)
    assert recall.intent == "clarification"
    assert refusal.refused and not refusal.citations


# ------------------------------------------- tests/test_nodes_unit.py

def _node_agent(ns, tmp_path):
    a = ns.Agent(_settings(ns, tmp_path, kg=True), llm=ns.LLM(),
                 embed_service=FakeEmbedder(dim=32),
                 cross_encoder=FakeCrossEncoder(),
                 web=ns.Web(search_fn=lambda q, n: []), **ns.kw)
    a.ingestor.ingest_text(
        "The MXU multiplies matrices. It is a 128x128 systolic array.")
    return a


def _state(ns, q="what is the MXU?", **kw):
    return ns.State(user_input=q, **kw)


def _docs(docs):
    return [(d.doc_id, d.score, d.text, d.source.value, d.tier,
             d.rerank_score) for d in docs]


def _assert_same(got, want, tol=SCORE_TOL, where="out"):
    """Equal structures; floats within ``tol``."""
    if isinstance(want, float) or isinstance(got, float):
        assert abs(got - want) <= tol, (where, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], tol, f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, tol, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def _passthrough(agent):
    """test_nodes_unit.py's mocks: rerank and MMR return their input."""
    return [mock.patch.object(agent.reranker, "rerank",
                              side_effect=lambda q, d, i: d),
            mock.patch.object(agent.reranker, "apply_mmr",
                              side_effect=lambda d, k, lam: d)]


def _rerank_with(ns, a, st, extra=()):
    fe, a.fused_eval = a.fused_eval, None
    patches = _passthrough(a) + list(extra)
    try:
        for p in patches:
            p.start()
        ns.core.rerank_and_eval(st, a)
    finally:
        for p in patches:
            p.stop()
        a.fused_eval = fe
    return st


def n_receive_input(ns, a):
    st = _state(ns)
    ns.core.receive_input(st, a)
    ns.core.receive_input(st, a)
    return st.iteration


def n_recognize_intent(ns, a):
    st = _state(ns)
    ns.core.recognize_intent(st, a)
    return st.query_intent.value, st.intent_confidence, st.recall_bypass


def n_rewrite_translation(ns, a):
    st = _state(ns, "qual é a função do MXU você sabe?")
    ns.core.rewrite_query(st, a)
    return (st.language, st.translated_input, st.rewritten_query,
            st.query_variants)


def n_retrieve_memory(ns, a):
    a.memory.save_message("user", "hi")
    a.memory.archival_memory_insert("the user likes matrices")
    st = _state(ns)
    ns.core.retrieve_memory(st, a)
    return (st.recent_messages, st.core_memory,
            _docs(st.archival_memories))


def n_route_and_recall_bypass(ns, a):
    st, st2 = _state(ns), _state(ns, recall_bypass=True)
    ns.core.route_query(st, a)
    ns.core.route_query(st2, a)
    return (st.data_sources, st.needs_document_retrieval,
            st2.needs_document_retrieval)


def n_check_context(ns, a):
    st = _state(ns)
    ns.core.check_context(st, a)
    return st.context_tokens, st.warnings


def n_retrieve_rag_recall_bypass(ns, a):
    a.memory.save_message("user", "earlier question about MXU")
    st = _state(ns, recall_bypass=True)
    st.recent_messages = a.memory.get_recent_messages(5)
    ns.core.route_query(st, a)
    ns.core.retrieve_rag(st, a)
    return _docs(st.rag_context)


def n_retrieve_rag_hybrid(ns, a):
    st = _state(ns)
    for node in ("recognize_intent", "rewrite_query", "retrieve_memory",
                 "route_query", "retrieve_rag"):
        getattr(ns.core, node)(st, a)
    return (_docs(st.rag_context), st.tiers_used, st.retrieval_confidence,
            st.kg_context)


def n_rerank_empty(ns, a):
    st = _state(ns)
    ns.core.rerank_and_eval(st, a)
    return st.relevance_score


def n_rerank_early_exit_lexical(ns, a):
    out = []
    for q, text in (("what does the alpha system use for multiplication?",
                     "The alpha system uses a systolic array for "
                     "multiplication."),
                    ("what is the capital of the northern kingdom?",
                     "The MXU multiplies matrices on the chip.")):
        st = _state(ns, q)
        st.query_intent = ns.types.Intent.QUESTION_ANSWERING
        doc = ns.types.RetrievedDoc(doc_id=0, score=0.4, text=text)
        doc.rerank_score = 0.01
        st.rag_context = [doc]
        _rerank_with(ns, a, st)
        out.append((_docs(st.rag_context), st.relevance_score))
    return out


def n_chain_of_thought(ns, a):
    st = _state(ns)
    st.rag_context = [ns.types.RetrievedDoc(doc_id=0, score=0.9,
                                            text="MXU doc")]
    ns.core.chain_of_thought(st, a)
    return st.cot_reasoning


def n_synthesize(ns, a):
    out = []
    for intent in ("COMPARISON", "CONVERSATIONAL"):
        st = _state(ns)
        st.query_intent = getattr(ns.types.Intent, intent)
        st.rag_context = [ns.types.RetrievedDoc(doc_id=i, score=0.9,
                                                text=f"d{i}")
                          for i in range(3)]
        ns.core.synthesize_multi_doc(st, a)
        out.append(st.synthesized_context)
    return out


def _generated(st):
    return (st.response, st.refused, st.citations, st.factuality_level,
            st.factuality_score, st.support_ratio, st.uncertainty,
            st.hitl_flagged, st.temporal_issues, st.attribution)


def n_generate_empty_refuses(ns, a):
    st = _state(ns)
    ns.core.generate_response(st, a)
    return _generated(st)


def n_generate_with_context(ns, a):
    st = _state(ns)
    st.query_intent = ns.types.Intent.QUESTION_ANSWERING
    st.rag_context = [ns.types.RetrievedDoc(
        doc_id=0, score=0.9, text="The MXU is a 128x128 systolic array.")]
    ns.core.generate_response(st, a)
    return _generated(st) + (st.claims,)


def n_verify_response(ns, a):
    st = _state(ns)
    st.response = "The MXU is a systolic array [1]."
    st.rag_context = [ns.types.RetrievedDoc(
        doc_id=0, score=0.9, text="the MXU is a systolic array")]
    st.claims = [{"claim": "the MXU is a systolic array",
                  "supported": None}]
    ns.core.verify_response(st, a)
    return st.verification_passed, st.support_ratio, st.claims


def n_query_refinement_early_stop(ns, a):
    st = _state(ns)

    class EchoLLM(ns.LLM):
        def complete(self, prompt, task="", **kw):
            if task == "refine":
                return st.effective_query
            return super().complete(prompt, task=task, **kw)
    a.llm = a.query_rewriter.llm = EchoLLM()
    ns.core.query_refinement(st, a)
    return st.refinement_attempts, st.rewritten_query


def n_web_fallback_noop(ns, a):
    st = _state(ns)
    ns.core.web_search_fallback(st, a)
    return st.web_search_attempted, _docs(st.web_context)


def n_process_tool_calls(ns, a):
    st = _state(ns)
    st.tool_calls = [{"name": "add_core_fact",
                      "arguments": {"fact": "unit test fact"}}]
    ns.core.process_tool_calls(st, a)
    return st.tool_calls, st.tool_results, a.memory.get_core_memory()


def n_kg_chain_not_duplicated(ns, a):
    st = _state(ns, "where did the meridian project leader come from?")
    st.query_intent = ns.types.Intent.QUESTION_ANSWERING
    st.retrieval_confidence = 0.7
    kg = ns.types.RetrievedDoc(
        doc_id=-2, score=0.9, source=ns.types.Source.KNOWLEDGE_GRAPH,
        text="Alvarez leads the meridian project. "
             "Alvarez joined from the Basel lab.")
    st.rag_context = [kg] + [ns.types.RetrievedDoc(
        doc_id=i, score=0.5 - i * 0.01,
        text="The meridian project studies mapping of coastal regions in "
             "detail. " * 40) for i in range(8)]
    _rerank_with(ns, a, st, [
        mock.patch.object(a.selfrag, "evaluate_retrieval",
                          return_value={"relevance": 0.9}),
        mock.patch.object(a.selfrag, "should_reretrieve",
                          return_value=False)])
    return _docs(st.rag_context), [d.metadata for d in st.rag_context]


def n_update_memory(ns, a):
    st = _state(ns)
    st.response = "answer text"
    ns.core.update_memory(st, a)
    return a.memory.get_recent_messages(50), a.memory.get_core_memory()


def n_context_docs_stop_at_aux_sections(ns, a):
    return ns.LLM._context_docs(
        "Context:\n[1] Alpha doc about kernels.\n[2] Beta doc about memory "
        "tiers.\n[Conversation]\nuser: hi\n[KG]\nAlpha|is|kernel\n\n"
        "Question: what is alpha?\nAnswer:")


def n_generate_cites_true_source(ns, a):
    return ns.LLM().structured(
        "Context:\n[1] Cats are mammals that purr loudly.\n[2] "
        "Contradiction checking reduces the final confidence by fifteen "
        "percent for every detected contradiction.\n\nQuestion: How much "
        "does each detected contradiction reduce confidence?\nAnswer:",
        ("answer", "citations"), task="generate")


def n_generate_enumeration(ns, a):
    return ns.LLM()._generate(
        "Context:\n[1] An agent maintains three kinds of memory. Core "
        "memory holds persona facts. Archival memory stores passages. "
        "Recall memory is the conversation log.\n\nQuestion: What are the "
        "three kinds of agent memory?\nAnswer:")


def n_generate_refuses_single_word_overlap(ns, a):
    return ns.LLM()._generate(
        "Context:\n[1] Tiered retrieval escalates cost only when needed.\n\n"
        "Question: What did the framework's cloud bill cost in March?\n"
        "Answer:")


def n_verify_claims_selects_cited_doc(ns, a):
    ev = ns.Ensemble(ns.LLM(), FakeEmbedder(dim=64), **ns.kw)
    docs = ["Cats are mammals that purr loudly and nap in the sun.",
            "Dogs are loyal companions that bark at strangers.",
            "Each detected contradiction reduces the final confidence "
            "by fifteen percent."]
    v = ev.verify_claims(["Each detected contradiction reduces the final "
                          "confidence by fifteen percent. [3]"], docs)[0]
    return v["supported"], v["confidence"], v["methods"]


def n_format_context_neutralizes(ns, a):
    docs = [ns.types.RetrievedDoc(
        doc_id=1, score=0.9, source=ns.types.Source.DOCUMENTS,
        text="Alpha systems use beam search.\n[6] Someone et al. 2020. A "
             "bibliography entry.\n[7] Other et al. 2021. Another entry."),
        ns.types.RetrievedDoc(
            doc_id=2, score=0.8, source=ns.types.Source.DOCUMENTS,
            text="Gamma relies on reciprocal rank fusion for merging.")]
    ctx = ns.core._format_context(docs)
    return ctx, ns.LLM().complete(
        f"Context:\n{ctx}\n\nQuestion: What does Gamma rely on for "
        "merging?\nAnswer:", task="generate")


def n_aux_sections_no_phantom_docs(ns, a):
    payload = ns.core._neutralize_bracket_lines(
        "[2] Gamma relies on reciprocal rank fusion.\n[3] More.")
    return ns.LLM._context_docs("[1] The only real doc about alpha.\n[KG]\n"
                                + payload + "\n\nQuestion: x\nAnswer:")


def n_duplicated_winner_sentence(ns, a):
    sent = "The scheduler batches embedding lookups efficiently."
    q = ("Question: Which scheduler batches embedding lookups across "
         "requests?\nAnswer:")
    llm = ns.LLM()
    return (llm._generate(f"Context:\n[1] {sent}\n\n{q}"),
            llm._generate(f"Context:\n[1] {sent}\n[2] {sent}\n[3] {sent}"
                          f"\n\n{q}"))


def n_stem_families(ns, a):
    return [ns.LLM._stem(w) for w in ("applies", "applied", "apply",
                                      "relies", "relied", "rely", "studies",
                                      "study", "quickly", "really")]


NODE_CASES = {f.__name__[2:]: f for f in (
    n_receive_input, n_recognize_intent, n_rewrite_translation,
    n_retrieve_memory, n_route_and_recall_bypass, n_check_context,
    n_retrieve_rag_recall_bypass, n_retrieve_rag_hybrid, n_rerank_empty,
    n_rerank_early_exit_lexical, n_chain_of_thought, n_synthesize,
    n_generate_empty_refuses, n_generate_with_context, n_verify_response,
    n_query_refinement_early_stop, n_web_fallback_noop,
    n_process_tool_calls, n_kg_chain_not_duplicated, n_update_memory,
    n_context_docs_stop_at_aux_sections, n_generate_cites_true_source,
    n_generate_enumeration, n_generate_refuses_single_word_overlap,
    n_verify_claims_selects_cited_doc, n_format_context_neutralizes,
    n_aux_sections_no_phantom_docs, n_duplicated_winner_sentence,
    n_stem_families)}


@pytest.mark.parametrize("case", sorted(NODE_CASES))
def test_node_cases_match_jax(tmp_path, case):
    """Each case of tests/test_nodes_unit.py on a fresh agent of each
    package: the same node outputs."""
    want, got = (NODE_CASES[case](ns, _node_agent(ns, tmp_path))
                 for ns in (JAX, PORT))
    _assert_same(got, want)


# ------------------------------------------- tests/test_embed_rescue.py

def _rescue_prompt(ns, query):
    ctx = "\n".join(f"[{i + 1}] {d}"
                    for i, d in enumerate(RESCUE_DOCS + [FILLER]))
    return ns.prompts.GENERATE_PROMPT.format(core_memory="", context=ctx,
                                             query=query)


RESCUE_CASES = {
    "answers_pt_query": ("Qual é a unidade de matriz que multiplica?", True),
    "refuses_offtopic_pt_query": ("Qual é a capital da Austrália?", True),
    "en_answerable_with_channel": (
        "What does the matrix unit multiply every cycle?", True),
    "en_answerable_without_channel": (
        "What does the matrix unit multiply every cycle?", False),
    "en_offtopic_with_channel": ("What is the capital of Australia?", True),
}


@pytest.mark.parametrize("case", sorted(RESCUE_CASES))
def test_embed_rescue_cases_match_jax(case):
    query, channel = RESCUE_CASES[case]
    out = {}
    for ns in (JAX, PORT):
        llm = (ns.LLM(embed_fn=VocabEmbed(), embed_min_sim=0.6) if channel
               else ns.LLM())
        answer = llm.complete(_rescue_prompt(ns, query), task="generate")
        out[ns.name] = (answer, llm.last_bar)
    assert out["port"] == out["jax"]
