"""RAGAgent: component wiring + graph compilation + chat().

Equivalent of the reference MemGPTRAGAgent (agent/rag_graph.py:70-530):
``__init__`` builds every component (cf. _initialize_rag, :108), the graph
reproduces the 16-node / 3-loop workflow (:319-418), and ``chat`` runs one
turn returning a ChatResponse (:420-530).

The big architectural difference (SURVEY.md §7): embedding, reranking,
retrieval, consistency, and compression scoring all run on the device
through engine/ + ops/; the LLM provider is only needed for text generation
and judgment calls — and a deterministic offline provider is the default.

Held against ``optimized_rag_tpu/agent/agent.py``. ``RAGAgent`` takes
``device`` ("cuda" unless the caller passes "cpu") and hands it to every
component that computes on the device: the encoder services, the dense and
lexical indexes, memory, the reranker's MMR, consistency, the rewriter's
and the verifiers' cosines, ``build_index_for`` and restored snapshots.
``corpus_dtype`` goes to ``DenseIndex`` as its string. The fused paths
drive the services' torch module, so they are taken where the service
exposes ``model`` (injected fakes without one take the modular path).
Without a checkpoint the encoders are random from the port's own seeds,
which cannot equal the JAX package's random ones.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

from optimized_rag_tpu_torch.agent import nodes
from optimized_rag_tpu_torch.agent.graph import END, StateGraph
from optimized_rag_tpu_torch.agent.llm import DeterministicLLM, LLMProvider
from optimized_rag_tpu_torch.agent.rewriter import (
    ConversationReferenceDetector, IntentRecognizer, QueryRewriter,
    QueryRouter)
from optimized_rag_tpu_torch.agent.state import AgentState, ChatResponse
from optimized_rag_tpu_torch.agent.tools import (
    ToolRegistry, create_memory_tools, create_rag_tools)
from optimized_rag_tpu_torch.agent.verification import (
    AttributionMapper, CitationValidator, ConfidenceCalibrator,
    EnsembleVerifier, FactualityScorer, SelfRAGEvaluator, TemporalValidator)
from optimized_rag_tpu_torch.agent.web import WebSearchTool
from optimized_rag_tpu_torch.config import Settings
from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.engine.compressor import ContextCompressor
from optimized_rag_tpu_torch.engine.consistency import ConsistencyChecker
from optimized_rag_tpu_torch.engine.hierarchical import HierarchicalRetriever
from optimized_rag_tpu_torch.engine.rerank import SelectiveReranker
from optimized_rag_tpu_torch.engine.retriever import HybridRetriever
from optimized_rag_tpu_torch.engine.types import RetrievedDoc, Source
from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.index.lexical import LexicalIndex
from optimized_rag_tpu_torch.store.cost import CostTracker
from optimized_rag_tpu_torch.store.db import MetadataStore
from optimized_rag_tpu_torch.store.kg import (
    KnowledgeGraphExtractor, KnowledgeGraphRetriever)
from optimized_rag_tpu_torch.store.memory import MemoryManager
from optimized_rag_tpu_torch.engine.adaptive import DynamicWeightManager


def _truthy(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


class RAGAgent:
    def __init__(self, settings: Optional[Settings] = None,
                 llm: Optional[LLMProvider] = None,
                 embed_service=None, cross_encoder=None,
                 store: Optional[MetadataStore] = None,
                 web: Optional[WebSearchTool] = None,
                 ingestor=None, device="cuda"):
        self.settings = settings or Settings()
        s = self.settings
        self.device = dev = resolve_device(device)
        self.llm = llm or DeterministicLLM(
            min_weighted=s.verification.extractive_min_weighted,
            min_coverage=s.verification.extractive_min_coverage,
            min_evidence_mass=s.verification.extractive_min_evidence_mass,
            embed_min_sim=s.verification.extractive_embed_min_sim)

        # Kept for the reference's callers (utils/compile_cache): the port
        # has no XLA cache to enable, and the call returns False.
        from optimized_rag_tpu_torch.utils.compile_cache import (
            setup_compilation_cache)
        setup_compilation_cache(s)

        # Models (on-device; built lazily if not injected). Trained
        # checkpoints auto-load — search order: <data_dir>/models, then the
        # repo's bundled checkpoints/pretrained (models/pretrain.py); the
        # checkpoint's own config wins so architecture always matches the
        # trained weights.
        from optimized_rag_tpu_torch.models.pretrain import (
            find_checkpoint_dir, load_pretrained, load_tokenizer)
        ckpt_dir = find_checkpoint_dir(s.data_dir)
        if embed_service is None:
            from optimized_rag_tpu_torch.models.encoder import (
                EmbeddingService, TransformerConfig)
            loaded = load_pretrained(ckpt_dir, "biencoder") \
                if ckpt_dir else None
            if loaded is not None:
                cfg, params = loaded
                embed_service = EmbeddingService(
                    cfg, params=params,
                    max_len=min(cfg.max_seq_len, 128),
                    cache_size=s.encoder.cache_size,
                    tokenizer=load_tokenizer(ckpt_dir, cfg.vocab_size,
                                             min(cfg.max_seq_len, 128)),
                    device=dev)
            else:
                embed_service = EmbeddingService(
                    TransformerConfig(
                        vocab_size=s.encoder.vocab_size,
                        hidden_dim=s.encoder.hidden_dim,
                        num_layers=s.encoder.num_layers,
                        num_heads=s.encoder.num_heads,
                        mlp_dim=s.encoder.mlp_dim,
                        out_dim=s.encoder.dim),
                    max_len=128, cache_size=s.encoder.cache_size, device=dev)
        self.embedder = embed_service
        self.embed_fn = embed_service.encode
        self.embed_batcher = None
        if s.serving.concurrent_chat:
            # Coalesce embedding dispatches across concurrent chat turns
            # (claim verification is the dominant per-turn dispatch):
            # every component below receives the batched entry point.
            from optimized_rag_tpu_torch.serving import EmbedBatcher
            self.embed_batcher = EmbedBatcher(
                embed_service.encode,
                max_texts=s.serving.embed_batch_max).start()
            self.embed_fn = self.embed_batcher.encode
        # Give the extractive generator the encoder for its embedding
        # rescue channel (zero-lexical-overlap queries; a caller-supplied
        # provider with its own embed_fn is left untouched).
        if isinstance(self.llm, DeterministicLLM) \
                and self.llm.embed_fn is None:
            self.llm.embed_fn = self.embed_fn
        # The reference always loads its cross-encoder rerank stage
        # (rag/reranker.py:313); build ours by default, flag-gated.
        if cross_encoder is None and s.rerank.enable_cross_encoder:
            from optimized_rag_tpu_torch.models.encoder import (
                CrossEncoderService, TransformerConfig as _TC)
            loaded = load_pretrained(ckpt_dir, "crossencoder") \
                if ckpt_dir else None
            if loaded is not None:
                ccfg, cparams = loaded
                cross_encoder = CrossEncoderService(
                    ccfg, params=cparams,
                    max_len=min(ccfg.max_seq_len, 256),
                    tokenizer=load_tokenizer(ckpt_dir, ccfg.vocab_size,
                                             min(ccfg.max_seq_len, 256)),
                    device=dev)
            else:
                cross_encoder = CrossEncoderService(
                    _TC(vocab_size=s.encoder.vocab_size,
                        hidden_dim=s.cross_encoder.hidden_dim,
                        num_layers=s.cross_encoder.num_layers,
                        num_heads=s.cross_encoder.num_heads,
                        mlp_dim=s.cross_encoder.mlp_dim),
                    max_len=min(s.cross_encoder.max_seq_len, 256),
                    device=dev)
        self.cross_encoder = cross_encoder

        # Storage + indexes.
        self.store = store or MetadataStore(":memory:")
        dim = getattr(embed_service, "dim", s.encoder.dim)
        self.dense = DenseIndex(dim=dim, capacity_block=65536, tile=1024,
                                dtype=s.retrieval.corpus_dtype, device=dev)
        self.lexical = LexicalIndex(device=dev)
        self.cost_tracker = CostTracker() \
            if s.flags.enable_cost_tracking else None

        # Memory.
        self.memory = MemoryManager(
            self.store, self.embed_fn, agent_id=s.agent_id, embed_dim=dim,
            persona=s.memory.persona,
            core_limit_chars=s.memory.core_memory_limit_chars, device=dev)

        # Query understanding.
        detector = ConversationReferenceDetector(self.embed_fn, self.llm,
                                                 device=dev)
        self.intent_recognizer = IntentRecognizer(self.llm, detector)
        self.query_rewriter = QueryRewriter(self.llm)
        self.router = QueryRouter()

        # KG.
        self.kg_extractor = KnowledgeGraphExtractor(
            self.store, s.agent_id,
            llm_fn=functools.partial(self.llm.complete,
                                     task="extract_triples"))
        self.kg_retriever = KnowledgeGraphRetriever(self.store, s.agent_id) \
            if s.flags.enable_kg else None

        # Retrieval engine.
        self.retriever = HybridRetriever(
            self.dense, self.lexical, self.embed_fn,
            get_text=self.store.chunk_text,
            get_created_at=self.store.chunk_created_at,
            half_life_days=s.retrieval.recency_half_life_days,
            candidate_k=s.retrieval.candidate_k,
            encoder=(embed_service if s.retrieval.fuse_query_encoder
                     and hasattr(embed_service, "model") else None))
        self.weight_manager = DynamicWeightManager(
            agent_id=s.agent_id, learning_rate=s.adaptive.learning_rate,
            window_size=s.adaptive.window_size,
            persist_every=s.adaptive.persist_every, db=self.store) \
            if s.flags.enable_dynamic_weights else None
        self.web = web if web is not None else WebSearchTool(
            cost_tracker=self.cost_tracker)
        self.hierarchical = HierarchicalRetriever(
            self.retriever, core_memory_fn=self.memory.get_core_memory,
            tier3_fn=self._tier3, escalation_threshold=s.tiers.
            escalation_threshold,
            tier1_min_score=s.tiers.tier1_keyword_min_score) \
            if s.flags.enable_hierarchical_retrieval else None

        # Rerank / compress / consistency.
        self.reranker = SelectiveReranker(
            cross_encoder=self.cross_encoder, embed_fn=self.embed_fn,
            config=s.rerank, device=dev)
        # One-dispatch post-retrieval scoring (rerank+MMR+relevance+
        # consistency); keeps the SelectiveReranker policy/stats.
        # The fused path drives the cross-encoder's torch module
        # directly; injected test fakes without one fall back to the
        # modular components.
        if s.flags.enable_fused_turn and (
                self.cross_encoder is None
                or hasattr(self.cross_encoder, "model")):
            from optimized_rag_tpu_torch.engine.fused import FusedRerankEval
            self.fused_eval = FusedRerankEval(
                self.reranker, self.embed_fn,
                cross_encoder=self.cross_encoder)
        else:
            self.fused_eval = None
        self.compressor = ContextCompressor(
            self.embed_fn, max_tokens=s.context.compression_target_tokens,
            semantic_weight=s.context.semantic_weight,
            lexical_weight=s.context.lexical_weight)
        self.consistency = ConsistencyChecker(
            self.embed_fn,
            sim_threshold=s.verification.consistency_sim_threshold,
            contradiction_penalty=s.verification.contradiction_penalty,
            device=dev)

        # Verification stack.
        self.ensemble = EnsembleVerifier(
            self.llm, self.embed_fn,
            weights=s.verification.ensemble_weights,
            embedding_threshold=s.verification.embedding_verify_threshold,
            llm_override_conf=s.verification.ensemble_llm_override_conf,
            device=dev) if s.flags.enable_ensemble_verification else None
        self.selfrag = SelfRAGEvaluator(
            self.llm, self.embed_fn, ensemble=self.ensemble,
            max_claims=s.verification.max_claims,
            hallucination_support=s.verification.hallucination_support_ratio,
            uncited_ratio_limit=s.verification.uncited_sentence_ratio,
            device=dev)
        self.citation_validator = CitationValidator()
        self.factuality = FactualityScorer(
            weights=s.verification.factuality_weights,
            zero_citation_penalty=s.verification.zero_citation_penalty,
            refusal_threshold=s.verification.refusal_threshold)
        self.attribution = AttributionMapper()
        self.temporal_validator = TemporalValidator()
        self.calibrator = ConfidenceCalibrator()
        # RAGAS metrics (reference rag_graph.py builds RAGASEvaluator in
        # _initialize_rag; here the facade computes natively on-device
        # when the ragas package is absent — eval/metrics.py).
        from optimized_rag_tpu_torch.eval.metrics import RAGASEvaluator
        self.ragas = RAGASEvaluator(embed_fn=self.embed_fn)

        # Host-side shared-state guard for concurrent chat turns
        # (server.concurrent_chat widens the chat lock to a semaphore;
        # DW-GRPO feedback, memory appends, and daily metrics are cheap
        # host ops that must still serialize — ADVICE r3).
        import threading
        self.mutate_lock = threading.RLock()

        # Observability (SURVEY.md §5: per-stage tracing, absent in the
        # reference beyond ad-hoc logs).
        import os
        from optimized_rag_tpu_torch.utils.profiling import StageTimer
        from optimized_rag_tpu_torch.utils.metrics_export import (
            MetricsExporter)
        self.timer = StageTimer()
        self.metrics_exporter = MetricsExporter(
            os.path.join(s.data_dir, "metrics_logs")) \
            if s.flags.enable_metrics_export else None

        # Ingestion + tools.
        if ingestor is None:
            from optimized_rag_tpu_torch.services.ingest import (
                DocumentIngestor)
            ingestor = DocumentIngestor(self)
        self.ingestor = ingestor
        self.tools = ToolRegistry()
        for t in create_memory_tools(self.memory):
            self.tools.register(t)
        for t in create_rag_tools(self.ingestor, self.retriever,
                                  self.web if self.web.available else None):
            self.tools.register(t)

        self.graph = self._build_graph()

    # ---------------------------------------------------------- index policy

    def maybe_upgrade_index(self) -> str:
        """Consult the index policy (index/policy.py) and (re)build an ANN
        candidate source when the corpus scale warrants one. The exact
        DenseIndex always remains the store of record: the ANN covers the
        built segment, exact search covers the fresh tail, and the
        retriever unions both. Returns the active index kind."""
        from optimized_rag_tpu_torch.index.policy import (
            build_index_for, mesh_or_none, select_index_kind)
        s = self.settings
        mesh = mesh_or_none(s)
        n_dev = mesh.shape[s.mesh.data_axis] if mesh is not None else 1
        kind = select_index_kind(self.dense.size, n_dev,
                                 ivf_min_size=s.ivf.ivf_min_size,
                                 shard_min_size=s.ivf.shard_min_size)
        if kind == "dense":
            self.retriever.ann = None
            self.retriever.ann_size = 0
            return kind
        expected = {"ivf": "IVFIndex", "sharded_dense": "ShardedDenseIndex",
                    "sharded_ivf": "ShardedIVFIndex"}[kind]
        stale = (self.retriever.ann is None
                 or self.retriever.ann_size * s.ivf.rebuild_growth
                 <= self.dense.size
                 or type(self.retriever.ann).__name__ != expected)
        if stale:
            # Dequantized f32 in int8 mode: normalize() inside the IVF
            # build would truncate raw int8 codes back to int8 zeros.
            # That whole-corpus f32 materialization is 4x the int8
            # resident bytes — near the int8 single-chip capacity
            # ceiling it would OOM even though the exact scan fits, so
            # int8 corpora keep the exact dense path once the dequant
            # would dominate HBM (the ceiling applies to the exact
            # path; ANN overlays cap out 4x earlier).
            if self.dense.quantized:
                f32_bytes = self.dense.size * self.dense.dim * 4
                if f32_bytes > s.ivf.int8_ann_f32_budget:
                    self.retriever.ann = None
                    self.retriever.ann_size = 0
                    return "dense"
            ann = build_index_for(kind, self.dense.dim, s, mesh=mesh,
                                  tile=self.dense.tile, device=self.device)
            emb = self.dense.vectors_f32()
            if hasattr(ann, "build"):          # IVF family: frozen build
                ann.build(emb, balanced=s.ivf.balanced_build)
            else:                              # sharded dense: appendable
                ann.add(emb)
            self.retriever.ann = ann
            self.retriever.ann_size = self.dense.size
        return kind

    # ----------------------------------------------------------------- tier3

    def _tier3(self, query: str, intent, context_docs=None):
        """tier3_fn hook for the hierarchical retriever."""
        return self.tier3_agentic_search(query, existing_context=context_docs,
                                         intent=intent)

    def tier3_agentic_search(self, query: str, existing_context=None,
                             intent=None, top_k: int = 3):
        """Agentic tier-3 (reference hierarchical_retriever.py:501-660;
        public re-entry :701, used for retroactive escalation from Self-RAG
        evaluation via the web_search_fallback node).

        KG traversal is on-device-cheap and always runs; the expensive web
        call is LLM-gated: the LLM judges tier-1/2 context sufficiency and,
        when escalating, may reformulate the search query. On LLM failure,
        fall back to a direct web search (:610-626).
        """
        from optimized_rag_tpu_torch.agent import prompts
        from optimized_rag_tpu_torch.agent.rewriter import (
            is_conversation_context_query)
        out = []
        if self.kg_retriever is not None:
            ctx = self.kg_retriever.query_knowledge_graph(query)
            if ctx:
                out.append(RetrievedDoc(doc_id=-3000, score=0.6, text=ctx,
                                        source=Source.KNOWLEDGE_GRAPH,
                                        tier=3))
        if self.web is None or not self.web.available:
            return out
        # Guard: conversation-context queries gain nothing from the web
        # (reference :523-529) — the recall path answers those.
        if is_conversation_context_query(query):
            return out
        docs = list(existing_context or [])
        summary = "No local context available."
        if docs:
            summary = "\n".join(
                f"[{i + 1}] (score: {d.score:.2f}) {d.text[:200]}"
                for i, d in enumerate(docs[:3]))
        try:
            decision = self.llm.structured(
                prompts.TIER3_AGENTIC_PROMPT.format(query=query,
                                                    context=summary),
                keys=("sufficient", "use_web_search", "search_query"),
                task="tier3_decision")
            if _truthy(decision.get("sufficient")) \
                    or not _truthy(decision.get("use_web_search")):
                return out  # local context judged sufficient (:605-607)
            search_q = str(decision.get("search_query") or query).strip() \
                or query
            results = self.web.search(search_q, max_results=top_k)
            for d in results:
                d.tier = 3
                d.score = 0.8  # LLM decided it was needed (:590)
                d.metadata["llm_decided"] = True
                d.metadata["search_query"] = search_q
            out.extend(results)
        except Exception:
            try:  # direct web search fallback (:610-626)
                results = self.web.search(query, max_results=top_k)
                for d in results:
                    d.tier = 3
                    d.score = 0.7
                    d.metadata["fallback"] = True
                out.extend(results)
            except Exception:
                pass
        return out

    # ----------------------------------------------------------------- graph

    def _build_graph(self):
        a = self
        g = StateGraph(max_steps=64)

        def n(fn):
            name = fn.__name__

            def wrapped(state):
                with a.timer.span(name):
                    return fn(state, agent=a)
            return wrapped

        g.add_node("receive_input", n(nodes.receive_input))
        g.add_node("recognize_intent", n(nodes.recognize_intent))
        g.add_node("rewrite_query", n(nodes.rewrite_query))
        g.add_node("retrieve_memory", n(nodes.retrieve_memory))
        g.add_node("route_query", n(nodes.route_query))
        g.add_node("check_context", n(nodes.check_context))
        g.add_node("retrieve_rag", n(nodes.retrieve_rag))
        g.add_node("rerank_and_eval", n(nodes.rerank_and_eval))
        g.add_node("chain_of_thought", n(nodes.chain_of_thought))
        g.add_node("synthesize_multi_doc", n(nodes.synthesize_multi_doc))
        g.add_node("generate_response", n(nodes.generate_response))
        g.add_node("verify_response", n(nodes.verify_response))
        g.add_node("query_refinement", n(nodes.query_refinement))
        g.add_node("web_search_fallback", n(nodes.web_search_fallback))
        g.add_node("process_tool_calls", n(nodes.process_tool_calls))
        g.add_node("update_memory", n(nodes.update_memory))

        g.set_entry("receive_input")
        g.add_edge("receive_input", "recognize_intent")
        g.add_edge("recognize_intent", "rewrite_query")
        g.add_edge("rewrite_query", "retrieve_memory")
        g.add_edge("retrieve_memory", "route_query")
        g.add_edge("route_query", "check_context")
        g.add_edge("check_context", "retrieve_rag")
        g.add_edge("retrieve_rag", "rerank_and_eval")
        g.add_conditional(
            "rerank_and_eval", lambda st: nodes.should_use_cot(st, a),
            {"cot": "chain_of_thought", "skip": "synthesize_multi_doc"})
        g.add_edge("chain_of_thought", "synthesize_multi_doc")
        g.add_edge("synthesize_multi_doc", "generate_response")
        g.add_conditional(
            "generate_response", lambda st: nodes.should_regenerate(st, a),
            {"regenerate": "generate_response", "accept": "verify_response"})
        g.add_conditional(
            "verify_response", lambda st: nodes.decide_next_action(st, a),
            {"tools": "process_tool_calls",
             "web_search": "web_search_fallback",
             "refine": "query_refinement",
             "continue": "update_memory"})
        g.add_edge("process_tool_calls", "generate_response")
        g.add_edge("web_search_fallback", "generate_response")
        g.add_edge("query_refinement", "retrieve_rag")
        g.add_edge("update_memory", END)
        return g.compile()

    # ------------------------------------------------------------ snapshots

    def save_indexes(self, directory: Optional[str] = None) -> str:
        """Persist dense/lexical/archival index state (the SQLite store is
        already durable; the device-side indexes must snapshot separately —
        index/snapshot.py)."""
        import os
        from optimized_rag_tpu_torch.index import snapshot
        directory = directory or os.path.join(self.settings.data_dir,
                                              "indexes")
        snapshot.save_state(directory, "dense", self.dense.state_dict())
        snapshot.save_state(directory, "lexical", self.lexical.state_dict())
        snapshot.save_state(directory, "archival",
                            self.memory.archival.state_dict())
        return directory

    def load_indexes(self, directory: Optional[str] = None) -> bool:
        """Restore index state saved by save_indexes. Returns False when no
        snapshot exists (fresh agent)."""
        import os
        from optimized_rag_tpu_torch.index import snapshot
        from optimized_rag_tpu_torch.index.dense import DenseIndex
        from optimized_rag_tpu_torch.index.lexical import LexicalIndex
        directory = directory or os.path.join(self.settings.data_dir,
                                              "indexes")
        if not snapshot.exists(directory, "dense"):
            return False
        self.dense = DenseIndex.from_state_dict(
            snapshot.load_state(directory, "dense"), device=self.device)
        self.lexical = LexicalIndex.from_state_dict(
            snapshot.load_state(directory, "lexical"), device=self.device)
        if snapshot.exists(directory, "archival"):
            self.memory.archival = DenseIndex.from_state_dict(
                snapshot.load_state(directory, "archival"),
                device=self.device)
        # Rebind components that captured the old index objects.
        self.retriever.dense = self.dense
        self.retriever.lexical = self.lexical
        return True

    # ---------------------------------------------------------------- warmup

    def warmup(self, deep: bool = False) -> float:
        """Run the hot shapes once (encoder buckets, the hybrid query,
        rerank) so the first real chat turn does not pay the first calls'
        setup: on the card, the top-k kernels' build, cuBLAS handles and
        the caching allocator's blocks at each shape. ``deep`` also warms
        the verification-stage shapes (claim batch cosine, pairwise
        consistency). Returns seconds."""
        t0 = time.time()
        if self.device.type == "cuda":
            # The top-k kernels (ops/_build.py): nvcc builds their library
            # once per source and flags; a first dense search would pay it.
            from optimized_rag_tpu_torch.ops._build import load_library
            load_library()
        probe = ["warmup probe text one", "warmup probe text two"]
        self.embed_fn(probe)
        # Run EVERY pow2 sequence-length bucket the tokenizer can emit
        # (tokenizer._bucket_len ladder) once. Single-token filler words
        # pin the tokenized length, so each ladder rung runs exactly once.
        max_l = min(getattr(self.embedder, "max_len", 8), 128)
        ladder, length = [], 8
        while length <= max_l:
            ladder.append(length)
            length *= 2
        for rung in ladder:
            text = " ".join(f"w{i}" for i in range(rung - 2))
            self.embed_fn([f"warm {rung} {text[:4]}", text])
            if self.cross_encoder is not None:
                doc = " ".join(f"w{i}" for i in range(max(rung - 8, 2)))
                self.cross_encoder.score_pairs("warm query", [doc] * 5)
                if self.fused_eval is not None:
                    # The fused pass runs the cross-encoder forward
                    # itself, so each pair-length rung runs it once too.
                    from optimized_rag_tpu_torch.engine.types import (
                        Intent as _I, RetrievedDoc as _RD)
                    wdocs = [_RD(doc_id=-1, score=0.5, text=doc)
                             for _ in range(5)]
                    self.fused_eval.run("warm query", wdocs,
                                        _I.QUESTION_ANSWERING,
                                        k_mmr=5, lam=0.7)
        if self.dense.size > 0:
            # Full hybrid path (dual_topk + fuse_candidates, or the
            # one-call route) on the live corpus shapes.
            self.retriever.retrieve("warmup query", top_k=min(
                self.settings.retrieval.top_k, self.dense.size))
            if self.lexical.size > 0:
                self.lexical.search("warmup query", k=5)
        if self.cross_encoder is not None:
            self.cross_encoder.score_pairs("warmup", ["warmup doc"])
        if deep:
            from optimized_rag_tpu_torch.engine.types import (
                Intent, RetrievedDoc)
            docs = [RetrievedDoc(doc_id=-1, score=0.5,
                                 text=f"warmup doc {i}") for i in range(5)]
            self.selfrag.evaluate_retrieval("warmup query", docs)
            if self.ensemble is not None:
                for n in (1, 3, 10):
                    self.ensemble.verify_claims(
                        [f"warmup claim {i}" for i in range(n)],
                        "warmup evidence text")
            self.consistency.check_consistency(docs)
            if self.fused_eval is not None:
                # Run the fused rerank/eval pass for every
                # candidate-count bucket (8, 16, 32) in both routing
                # modes, plus the skip-policy ('none') shape.
                for n_docs in (5, 10, 20):
                    wdocs = [RetrievedDoc(doc_id=-1, score=0.5,
                                          text=f"warmup doc {i}")
                             for i in range(n_docs)]
                    for it in (Intent.QUESTION_ANSWERING,
                               Intent.CONVERSATIONAL):
                        self.fused_eval.run("warmup query", list(wdocs),
                                            it, k_mmr=5, lam=0.7)
                # High score variance + non-precision intent routes to
                # the 'none' (skip-rerank, eval-only) pass.
                vdocs = [RetrievedDoc(doc_id=-1,
                                      score=0.95 if i % 2 == 0 else 0.05,
                                      text=f"warmup doc {i}")
                         for i in range(8)]
                self.fused_eval.run("warmup query", vdocs,
                                    Intent.CONVERSATIONAL, k_mmr=5,
                                    lam=0.7)
        return time.time() - t0

    # ------------------------------------------------------------------ chat

    def chat(self, user_input: str, trace: Optional[list] = None
             ) -> ChatResponse:
        t0 = time.time()
        state = AgentState(user_input=user_input,
                           core_memory=self.memory.get_core_memory())
        self.graph.invoke(state, trace=trace)
        confidence = self.calibrator.calibrate(
            1.0 - state.uncertainty, state.support_ratio,
            had_contradictions=bool(
                state.consistency.get("contradictions")))
        # Feed DW-GRPO (reference adaptive_weights.py:433). Serialized:
        # concurrent turns share the tracker's sliding window.
        if self.weight_manager is not None and state.retrieval_weights:
            quality = state.factuality_score if not state.refused else 0.0
            with self.mutate_lock:
                self.weight_manager.record_feedback(
                    state.retrieval_weights, quality,
                    intent=getattr(state.query_intent, "value", None),
                    complexity=self.weight_manager.feature_extractor.
                    extract_complexity(user_input,
                                       getattr(state.query_intent, "value",
                                               None)))
        resp = ChatResponse(
            answer=state.response,
            citations=state.citations,
            sources=[{"doc_id": d.doc_id, "source": d.source.value,
                      "score": d.score, "tier": d.tier,
                      "text": (d.text or "")[:1600]}
                     for d in state.rag_context],
            confidence=confidence,
            factuality_score=state.factuality_score,
            factuality_level=state.factuality_level,
            support_ratio=state.support_ratio,
            faithfulness=state.faithfulness,
            refused=state.refused,
            hitl_flagged=state.hitl_flagged,
            intent=getattr(state.query_intent, "value", None),
            tiers_used=state.tiers_used,
            uncertainty=state.uncertainty,
            warnings=state.warnings,
            metrics={"latency_s": time.time() - t0,
                     "iteration": state.iteration,
                     "regenerations": state.regeneration_attempts,
                     "refinements": state.refinement_attempts,
                     "reretrieves": state.reretrieve_attempts,
                     "web_search": state.web_search_attempted})
        # Gray-zone answers land in the reviewable HITL queue
        # (store/db.py migration 2; reference only sets the flag,
        # generate_response.py:390-424).
        if state.hitl_flagged:
            try:
                self.store.hitl_enqueue(
                    self.settings.agent_id, user_input, state.response,
                    state.factuality_score, state.support_ratio)
            except Exception:
                pass  # review queue must never break a chat turn
        # Daily aggregates in the store (reference
        # dw_grpo_persistence.update_daily_metrics, :320).
        try:
            self.store.update_daily_metric(self.settings.agent_id,
                                           "queries", 1)
            for tier in state.tiers_used:
                self.store.update_daily_metric(self.settings.agent_id,
                                               f"tier{tier}_queries", 1)
            if state.refused:
                self.store.update_daily_metric(self.settings.agent_id,
                                               "refusals", 1)
        except Exception:
            pass  # metrics must never break a chat turn
        # JSONL metrics export (reference rag/nodes/helpers.py:643-674).
        if self.metrics_exporter is not None:
            try:
                self.metrics_exporter.export({
                    "kind": "chat_turn", "intent": resp.intent,
                    "factuality": resp.factuality_score,
                    "support_ratio": resp.support_ratio,
                    "confidence": resp.confidence,
                    "refused": resp.refused,
                    "tiers_used": resp.tiers_used,
                    "latency_s": resp.metrics["latency_s"]})
            except OSError:
                pass
        return resp
