"""Configuration dataclasses of the port.

A copy of ``optimized_rag_tpu/config.py``, the same fields and defaults
(the port keeps its own: it imports nothing of the JAX package). Mirrors the capability surface of the
reference's env-driven settings (reference: config.py:10-226,
optimization_config.py:11-105) as typed dataclasses with
environment-variable overrides, organized by subsystem. Every threshold
that drives control flow keeps the reference's name and default, so
behavior parity is checkable.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Dict, Tuple


def _env(name: str, default, cast=None):
    raw = os.environ.get(name)
    if raw is None:
        return default
    cast = cast or type(default)
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return cast(raw)


def _cast_like(raw: str, current):
    """Cast an env string to the type of the current field value."""
    if isinstance(current, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        parts = [p.strip() for p in raw.split(",") if p.strip()]
        elem = current[0] if current else raw
        return tuple(_cast_like(p, elem) for p in parts)
    if isinstance(current, dict):
        import json
        return json.loads(raw)
    return raw


# ---------------------------------------------------------------------------
# Chunking / ingestion  (reference: config.py:25-27, rag/chunking.py)
# ---------------------------------------------------------------------------

@dataclass
class ChunkingConfig:
    chunk_size: int = 1200          # characters (reference: config.py:25)
    chunk_overlap: int = 150        # reference: config.py:26
    strategy: str = "recursive"     # fixed | recursive | semantic
    semantic_threshold: float = 0.75  # cosine boundary (rag/chunking.py:174)
    max_semantic_chunk_chars: int = 2000
    min_chunk_chars: int = 50


# ---------------------------------------------------------------------------
# Embedding / encoder  (reference: memory/embeddings.py, optimization_config)
# ---------------------------------------------------------------------------

@dataclass
class EncoderConfig:
    dim: int = 384                  # on-device encoder output dim
    vocab_size: int = 32768
    hidden_dim: int = 384
    num_layers: int = 6
    num_heads: int = 12
    mlp_dim: int = 1536
    max_seq_len: int = 512
    dtype: str = "bfloat16"
    batch_size: int = 128           # reference batches at 100 (config.py:186)
    cache_size: int = 4096          # LRU entries (reference: 1000, embeddings.py:47)
    matryoshka_dims: Tuple[int, ...] = (384, 256, 128)  # optimization_config.py:15-19


@dataclass
class CrossEncoderConfig:
    hidden_dim: int = 384
    num_layers: int = 4
    num_heads: int = 12
    mlp_dim: int = 1536
    max_seq_len: int = 512
    max_pairs_per_batch: int = 64
    blend_original: float = 0.3     # 0.7*new + 0.3*orig (rag/reranker.py:77)


# ---------------------------------------------------------------------------
# Retrieval  (reference: rag/retrieval.py, rag/document_store.py)
# ---------------------------------------------------------------------------

@dataclass
class RetrievalConfig:
    top_k: int = 10
    candidate_k: int = 50           # dense candidates before rerank
    rrf_k: int = 60                 # RRF constant (rag/reranker.py:247)
    mmr_lambda: float = 0.7         # rag/reranker.py:181
    recency_half_life_days: float = 30.0  # 0.5^(days/half_life) (retrieval.py:283)
    # hybrid weights fallback (semantic, keyword, temporal) — per-intent
    # tables live in engine/adaptive.py (reference: retrieval.py:22-47)
    default_weights: Tuple[float, float, float] = (0.7, 0.2, 0.1)
    bm25_k1: float = 1.5
    bm25_b: float = 0.75
    max_query_terms: int = 32
    shard_axis: str = "data"        # mesh axis the corpus is sharded over
    # "bfloat16" halves the bytes a search reads; DenseIndex then
    # oversamples 4x and rescores in float32. "int8" quarters them
    # (per-row-scale symmetric quantization, ops/quantize.py), with the
    # same oversample and rescore.
    corpus_dtype: str = "float32"
    # Run the whole hybrid query (encoder forward + dual top-k + fusion)
    # as one call with one packed result (ops/fused_query.py).
    fuse_query_encoder: bool = True


@dataclass
class IVFConfig:
    num_clusters: int = 1024
    nprobe: int = 64
    kmeans_iters: int = 12
    min_points_per_cluster: int = 4
    oversample: float = 1.3         # candidate oversampling for recall safety
    # Index policy thresholds (index/policy.py). Round-2 measurement
    # (docs/RESULTS_r2.md): streaming exact brute force beats IVF — even
    # balanced-cluster IVF — at EVERY batch size through 10M x 128 bf16
    # on one v5e, so IVF only engages near the HBM streaming budget.
    ivf_min_size: int = 16_000_000
    shard_min_size: int = 250_000
    rebuild_growth: float = 2.0     # rebuild ANN when corpus grows this much
    balanced_build: bool = True     # balanced clusters: ~3.5x smaller window
    # int8 corpora: ANN (re)builds need a whole-corpus f32 dequant (4x
    # the int8 resident bytes); past this budget the agent keeps the
    # exact dense path instead of risking an OOM at the capacity
    # ceiling (agent.maybe_upgrade_index).
    int8_ann_f32_budget: int = 4 << 30


# ---------------------------------------------------------------------------
# Hierarchical 3-tier retrieval  (reference: rag/hierarchical_retriever.py)
# ---------------------------------------------------------------------------

@dataclass
class TierConfig:
    escalation_threshold: float = 0.7   # config.py:55
    tier1_keyword_min_score: float = 0.3
    # confidence blend: 0.35*avg + 0.25*count + 0.20*consistency + 0.20*top
    # (hierarchical_retriever.py:31-74)
    w_avg: float = 0.35
    w_count: float = 0.25
    w_consistency: float = 0.20
    w_top: float = 0.20
    semantic_blend: float = 0.4         # 60/40 blend with Self-RAG confidence (:86-90)
    expected_count: int = 5


# ---------------------------------------------------------------------------
# Reranking  (reference: rag/selective_reranker.py, rag/reranker.py)
# ---------------------------------------------------------------------------

@dataclass
class RerankConfig:
    enable_selective: bool = True
    # variance policy (selective_reranker.py:140-150): variance above
    # high_variance_skip = clear winners, skip; below low_variance_rerank =
    # similar scores, rerank helps.
    high_variance_skip: float = 0.1
    low_variance_rerank: float = 0.05
    low_score_force: float = 0.05       # force rerank when avg score below (:131)
    cross_encoder_threshold: float = 0.15  # CROSS_ENCODER_SCORE_THRESHOLD (config.py:201)
    rerank_top_k: int = 5
    blend_original: float = 0.3         # 0.7*new + 0.3*orig (rag/reranker.py:77)
    enable_cross_encoder: bool = True   # reference always loads it (reranker.py:313)


# ---------------------------------------------------------------------------
# Verification / anti-hallucination  (reference: config.py, self_rag.py, ...)
# ---------------------------------------------------------------------------

@dataclass
class VerificationConfig:
    min_support_ratio: float = 0.70      # MIN_SUPPORT_RATIO (config.py:190)
    hallucination_support_ratio: float = 0.6   # self_rag.py:341
    uncited_sentence_ratio: float = 0.5        # self_rag.py:351
    max_claims: int = 10                       # self_rag.py:299
    ensemble_weights: Tuple[float, float, float] = (0.5, 0.3, 0.2)  # llm/keyword/embedding
    ensemble_llm_override_conf: float = 0.85   # ensemble_verifier.py:349-368
    embedding_verify_threshold: float = 0.60   # ensemble_verifier.py:237
    exact_match_term_ratio: float = 0.60       # verify_response.py:18
    consistency_sim_threshold: float = 0.85    # consistency_checker.py:193
    contradiction_penalty: float = 0.15        # rerank_and_eval.py:176-186
    factuality_weights: Tuple[float, float, float, float] = (0.50, 0.25, 0.20, 0.05)
    zero_citation_penalty: float = 0.5         # factuality_scorer.py:66-69
    refusal_threshold: float = 0.50            # factuality_scorer.py:203
    web_search_factuality_trigger: float = 0.35  # decisions.py:78
    attribution_traceable_ratio: float = 0.95  # attribution_mapper.py
    # Extractive-generator relevance bar (DeterministicLLM._generate):
    # refuse when the best weighted sentence evidence AND the query's
    # idf-mass coverage are both low. Calibrated on the round-3 QA run,
    # validated on a FRESH held-out probe set the constants never saw
    # (eval/holdout_probes.py — VERDICT r3 next #5).
    extractive_min_weighted: float = 2.6
    extractive_min_coverage: float = 0.7
    # Coverage-weighted evidence rail for the low-coverage regime
    # (qcov < extractive_min_coverage): require best_weighted * qcov >=
    # this mass. Rationale: when the context misses most of the query's
    # distinctive idf mass, a strong-looking sentence is built from the
    # query's generic half — the evidence needed should scale inversely
    # with coverage. Observed post-encoder-swap: an off-topic probe's
    # winner scored 3.2-3.3 weighted at coverage 0.363 (product 1.17)
    # while the lowest legitimate answer sits at 4.08 x 0.428 = 1.75
    # (docs/results_r4/bar_calibration.jsonl). 1.45 is the log-midpoint;
    # validation stays on the untouched held-out probes.
    extractive_min_evidence_mass: float = 1.45
    # Embedding rescue channel (zero-lexical-overlap queries, e.g.
    # non-English with enable_translation=0): refusal bar on the best
    # sentence's cosine against the query in the cross-lingually
    # trained encoder space (agent/llm.DeterministicLLM._embed_extract).
    # Calibrated on the HOLDOUT probes' scripted pt/es/fr/de renderings
    # against the xl3 encoder — midpoint of off-topic p90 (0.49) and
    # answerable p10 (0.40); the QA sections the bar unlocks played no
    # part (benchmarks/calibrate_embed_bar.py ->
    # docs/results_r5/embed_bar.json). The round-4 0.60 default sat
    # ABOVE the answerable p50 (~0.55) and refused nearly every
    # legitimate cross-lingual query.
    extractive_embed_min_sim: float = 0.446


# ---------------------------------------------------------------------------
# Loop caps  (reference: config.py:31,63,198)
# ---------------------------------------------------------------------------

@dataclass
class LoopConfig:
    max_regeneration_attempts: int = 1
    max_refinement_attempts: int = 2
    max_reretrieve_attempts: int = 2
    progressive_top_k: Tuple[int, ...] = (15, 10, 5)  # config.py:205-209


# ---------------------------------------------------------------------------
# Context / compression  (reference: config.py:35,92-111,216-221)
# ---------------------------------------------------------------------------

@dataclass
class ContextConfig:
    max_context_tokens: int = 8000
    compression_target_tokens: int = 2000
    # token allocation budget (config.py:92-111)
    allocation: Dict[str, float] = field(default_factory=lambda: {
        "system": 0.10, "core_memory": 0.15, "conversation": 0.25,
        "rag_context": 0.40, "response": 0.10,
    })
    semantic_weight: float = 0.7    # _score_sentences_hybrid (context_compressor.py:217)
    lexical_weight: float = 0.3
    # per-intent compression thresholds (config.py:216-221)
    intent_thresholds: Dict[str, float] = field(default_factory=lambda: {
        "factual_lookup": 0.5, "summarization": 0.3, "chat": 0.7,
        "multi_hop": 0.4, "comparison": 0.4,
    })


# ---------------------------------------------------------------------------
# Memory  (reference: memory/manager.py)
# ---------------------------------------------------------------------------

@dataclass
class MemoryConfig:
    core_memory_limit_chars: int = 4000
    archival_search_top_k: int = 5
    recall_recent_messages: int = 10
    persona: str = "I am a helpful research assistant running on TPU."


# ---------------------------------------------------------------------------
# Adaptive weights / DW-GRPO  (reference: rag/adaptive_weights.py)
# ---------------------------------------------------------------------------

@dataclass
class AdaptiveConfig:
    learning_rate: float = 0.01          # alpha (adaptive_weights.py:385)
    window_size: int = 100               # PerformanceTracker (adaptive_weights.py:32)
    persist_every: int = 10              # adaptive_weights.py:490
    domain_boost: float = 0.1


# ---------------------------------------------------------------------------
# Parallelism / mesh
# ---------------------------------------------------------------------------

@dataclass
class MeshConfig:
    data_axis: str = "data"     # corpus-shard / batch axis
    model_axis: str = "model"   # tensor-parallel axis for encoder training
    data_parallel: int = 0      # 0 = infer from devices
    model_parallel: int = 1


# ---------------------------------------------------------------------------
# Feature flags  (reference: ~25 enable_* flags, config.py / optimization_config)
# ---------------------------------------------------------------------------

@dataclass
class ServingConfig:
    """Concurrent serving (serving.py / server.py)."""
    # Run chat turns concurrently in the HTTP server (no global chat
    # lock) and coalesce per-turn embedding dispatches across turns
    # through a shared EmbedBatcher. Default off: single-user CLI parity
    # with the reference, zero batching machinery in the way.
    concurrent_chat: bool = False
    max_concurrent_turns: int = 8
    # Upper bound on texts per coalesced embedding dispatch.
    embed_batch_max: int = 256


@dataclass
class Flags:
    enable_kg: bool = True
    enable_cot: bool = True
    enable_compression: bool = True
    enable_consistency_check: bool = True
    enable_temporal_validation: bool = True
    enable_attribution: bool = True
    enable_uncertainty: bool = True
    enable_hitl: bool = False
    enable_ensemble_verification: bool = True
    enable_hierarchical_retrieval: bool = True
    enable_dynamic_weights: bool = True
    enable_web_search_fallback: bool = True
    enable_selective_rerank: bool = True
    enable_self_rag: bool = True
    enable_citation_validation: bool = True
    enable_factuality_scoring: bool = True
    enable_query_rewriting: bool = True
    # Translate non-English queries before retrieval (reference
    # rag/nodes/rewrite_query.py:26-32). Off = rely on the encoder's
    # cross-lingual training (models/xlingual.py): pt/es/fr/de queries
    # embed directly into the EN chunk space.
    enable_translation: bool = True
    enable_intent_recognition: bool = True
    enable_multi_doc_synthesis: bool = True
    enable_memory_fact_extraction: bool = True
    enable_cost_tracking: bool = True
    enable_metrics_export: bool = True
    enable_profiling: bool = False
    # Fuse rerank + MMR + relevance + consistency scoring into one device
    # dispatch per turn (ops/fused_eval.py). Parity with the modular path
    # is tested; disable to force the modular components.
    enable_fused_turn: bool = True
    # Persist compiled XLA executables under <data_dir>/xla_cache (read by
    # the JAX package; kept so both packages share one settings schema).
    enable_compilation_cache: bool = True


@dataclass
class Settings:
    """Root settings object. Construct with overrides or from env."""
    chunking: ChunkingConfig = field(default_factory=ChunkingConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    cross_encoder: CrossEncoderConfig = field(default_factory=CrossEncoderConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    ivf: IVFConfig = field(default_factory=IVFConfig)
    tiers: TierConfig = field(default_factory=TierConfig)
    rerank: RerankConfig = field(default_factory=RerankConfig)
    verification: VerificationConfig = field(default_factory=VerificationConfig)
    loops: LoopConfig = field(default_factory=LoopConfig)
    context: ContextConfig = field(default_factory=ContextConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    adaptive: AdaptiveConfig = field(default_factory=AdaptiveConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    flags: Flags = field(default_factory=Flags)
    data_dir: str = field(default_factory=lambda: _env("ORAG_DATA_DIR", ".orag"))
    agent_id: str = "default"

    # Short aliases kept from round 1 (documented in .env.example).
    _ENV_ALIASES = {
        "ORAG_EMBED_DIM": ("encoder", "dim"),
        "ORAG_CHUNK_SIZE": ("chunking", "chunk_size"),
        "ORAG_CHUNK_OVERLAP": ("chunking", "chunk_overlap"),
        "ORAG_TOP_K": ("retrieval", "top_k"),
    }

    @classmethod
    def from_env(cls, environ=None) -> "Settings":
        """Build Settings with every field overridable from the
        environment: ``ORAG_<SECTION>_<FIELD>`` (e.g.
        ORAG_TIERS_ESCALATION_THRESHOLD=0.6, ORAG_FLAGS_ENABLE_KG=0).
        Tuples are comma-separated; dicts are JSON. Mirrors the
        reference's ~80 env-driven constants and ~25 flags
        (config.py:116-226, optimization_config.py:97-105); the full list
        is generated into .env.example (python -m optimized_rag_tpu
        env-example).
        """
        env = os.environ if environ is None else environ
        s = cls()
        for section_field in dataclasses.fields(s):
            section = getattr(s, section_field.name)
            if not dataclasses.is_dataclass(section):
                continue
            prefix = f"ORAG_{section_field.name.upper()}_"
            for f in dataclasses.fields(section):
                raw = env.get(prefix + f.name.upper())
                if raw is not None:
                    setattr(section, f.name,
                            _cast_like(raw, getattr(section, f.name)))
        for name, (sec, fld) in cls._ENV_ALIASES.items():
            raw = env.get(name)
            if raw is not None:
                obj = getattr(s, sec)
                setattr(obj, fld, _cast_like(raw, getattr(obj, fld)))
        s.data_dir = env.get("ORAG_DATA_DIR", s.data_dir)
        s.agent_id = env.get("ORAG_AGENT_ID", s.agent_id)
        return s

    @classmethod
    def env_var_names(cls):
        """All recognized (env var, default) pairs, for .env.example."""
        s = cls()
        out = []
        for section_field in dataclasses.fields(s):
            section = getattr(s, section_field.name)
            if not dataclasses.is_dataclass(section):
                continue
            for f in dataclasses.fields(section):
                val = getattr(section, f.name)
                if isinstance(val, tuple):
                    shown = ",".join(str(v) for v in val)
                elif isinstance(val, dict):
                    import json
                    shown = json.dumps(val)
                else:
                    shown = val
                out.append((section_field.name,
                            f"ORAG_{section_field.name.upper()}_"
                            f"{f.name.upper()}", shown))
        out.append(("root", "ORAG_DATA_DIR", s.data_dir))
        out.append(("root", "ORAG_AGENT_ID", s.agent_id))
        out.append(("root", "ORAG_COMPILE_CACHE_DIR",
                    "~/.cache/optimized_rag_tpu/xla"))
        return out

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


DEFAULT_SETTINGS = Settings()
