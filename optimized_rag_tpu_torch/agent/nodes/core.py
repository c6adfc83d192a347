"""The 16 workflow node bodies.

Each node is ``node(state, agent) -> None`` mutating the AgentState; the
``agent`` is the component container (agent/agent.py). Edge order and loop
semantics follow the reference graph (agent/rag_graph.py:324-417); per-node
behavior citations are on each function.

Held against ``optimized_rag_tpu/agent/nodes/core.py``, a copy whose
imports name the port's modules.
"""

from __future__ import annotations

import contextlib
import re
import time

_NULL_CTX = contextlib.nullcontext()
from typing import List


from optimized_rag_tpu_torch.agent import prompts
from optimized_rag_tpu_torch.agent.state import AgentState
from optimized_rag_tpu_torch.agent.verification import (
    exact_match_verify, quantify_uncertainty, split_sentences)
from optimized_rag_tpu_torch.engine.types import Intent, RetrievedDoc, Source

_NON_ASCII = re.compile(r"[^\x00-\x7F]")
_PT_HINTS = re.compile(
    r"\b(qual|quais|como|onde|quando|por ?que|quem|voc[eê]|n[aã]o|"
    r"fa[cç]a|sobre|entre)\b", re.IGNORECASE)


_STOPWORDS = frozenset(
    "the a an is are was were of to and in on by for with that this its as "
    "at or it what which who whom whose when where why how do does did can "
    "could would should will shall may might must have has had be been "
    "being not no i you he she we they me him her us them my your".split())


def _lexical_coverage(query: str, docs) -> float:
    """Best per-doc fraction of the query's content terms present."""
    terms = {w for w in re.findall(r"[a-z0-9]+", query.lower())
             if w not in _STOPWORDS and len(w) > 2}
    if not terms:
        return 1.0
    best = 0.0
    for d in docs:
        text = (d.text or "").lower()
        best = max(best, sum(t in text for t in terms) / len(terms))
    return best


def _zero_lexical_coverage(query: str, docs, intent) -> bool:
    """True when no content word of a factual query appears in any doc."""
    iv = getattr(intent, "value", intent) or ""
    if iv in ("conversational", "clarification", "task_execution"):
        return False
    return _lexical_coverage(query, docs) == 0.0


def _neutralize_bracket_lines(text: str) -> str:
    """Indent payload lines that start with ``[`` by one space so only
    the context assembler's own ``[N]``/``[Section]`` markers sit at
    line starts. Without this, bibliography entries like
    "[6] Kwiatkowski et al." in academic PDFs — or conversation text
    spoofing a section header — parse as phantom numbered docs and
    citation numbering silently shifts against ChatResponse.sources
    (caught by the qa_sheet pdf-* section)."""
    text = re.sub(r"\n(?=\[)", "\n ", text or "")
    return (" " + text) if text.startswith("[") else text


def _format_context(docs: List[RetrievedDoc]) -> str:
    """Numbered context with [N] ids (reference rag/nodes/helpers.py:20)."""
    return "\n".join(f"[{i + 1}] {_neutralize_bracket_lines(d.text)}"
                     for i, d in enumerate(docs))


# ---------------------------------------------------------------------------

def receive_input(state: AgentState, agent) -> None:
    """Bump iteration counter (reference rag/nodes/receive_input.py:13)."""
    state.iteration += 1


def recognize_intent(state: AgentState, agent) -> None:
    """LLM intent classification with conversation-reference pre-check
    (reference rag/nodes/recognize_intent.py:13)."""
    out = agent.intent_recognizer.recognize(state.user_input,
                                            state.recent_messages)
    state.query_intent = out["intent"]
    state.intent_confidence = out["confidence"]
    state.recall_bypass = out.get("is_conversation_reference", False)


def rewrite_query(state: AgentState, agent) -> None:
    """Translate-to-English if needed, then conditional rewrite
    (reference rag/nodes/rewrite_query.py:14-32)."""
    query = state.user_input
    if _is_non_english(query):
        state.language = "non-en"
        if agent.settings.flags.enable_translation:
            state.translated_input = agent.llm.complete(
                prompts.TRANSLATE_PROMPT.format(query=query),
                task="translate").strip() or query
            query = state.translated_input
        # else: the cross-lingually trained encoder embeds the query
        # into the EN chunk space directly (models/xlingual.py)
    out = agent.query_rewriter.rewrite(query, state.query_intent,
                                       state.recent_messages)
    state.rewritten_query = out["rewritten"]
    state.query_variants = out["variants"]


def _is_non_english(text: str) -> bool:
    """Language gate (reference uses langdetect, helpers.py:605).
    Stopword/diacritic identifier covering pt/es/fr/de (utils/lang.py),
    backed by the round-2 non-ASCII-ratio + PT-hint heuristics so
    short accented fragments still route to translation."""
    from optimized_rag_tpu_torch.utils.lang import is_non_english
    if is_non_english(text):
        return True
    non_ascii = len(_NON_ASCII.findall(text))
    return non_ascii / max(len(text), 1) > 0.05 or \
        bool(_PT_HINTS.search(text))


def retrieve_memory(state: AgentState, agent) -> None:
    """Archival semantic search (top 5) + recent recall (10)
    (reference rag/nodes/retrieve_memory.py:16-77)."""
    state.core_memory = agent.memory.get_core_memory()
    state.recent_messages = agent.memory.get_recent_messages(10)
    state.archival_memories = agent.memory.archival_memory_search(
        state.effective_query, top_k=5)
    if state.recall_bypass:  # extra substring recall for clarifications
        extra = agent.memory.conversation_search(state.effective_query, 5)
        state.recent_messages = (state.recent_messages + extra)[-15:]


def route_query(state: AgentState, agent) -> None:
    """Deterministic routing + doc-retrieval gate
    (reference rag/nodes/route_query.py:13, helpers.py:450)."""
    decision = agent.router.route(state.effective_query)
    state.data_sources = [s.value for s in decision["sources"]]
    # Recall-reference queries skip document retrieval.
    state.needs_document_retrieval = not state.recall_bypass


def check_context(state: AgentState, agent) -> None:
    """Token count of core memory vs budget
    (reference rag/nodes/check_context.py:13)."""
    core_text = agent.memory.format_core_memory()
    state.context_tokens = len(core_text) // 4
    if state.context_tokens > agent.settings.context.max_context_tokens:
        state.warnings.append("core memory exceeds context budget")


def retrieve_rag(state: AgentState, agent) -> None:
    """Hierarchical (or plain hybrid) retrieval + KG context
    (reference rag/nodes/retrieve_rag.py:16-117)."""
    if not state.needs_document_retrieval:
        # Recall-bypass path (:21-58): answer from conversation memory.
        state.rag_context = [
            RetrievedDoc(doc_id=-1, score=0.8,
                         text=f"{m['role']}: {m['content']}",
                         source=Source.CONVERSATION)
            for m in state.recent_messages[-5:]]
        return
    query = state.effective_query
    weights = None
    if agent.weight_manager is not None:
        weights = agent.weight_manager.calculate_optimal_weights(
            query, getattr(state.query_intent, "value", None))
        state.retrieval_weights = weights
    # Per-intent retrieval depth (reference intent_recognizer.py:168-223:
    # top_k 2-12 by intent); settings default when intent is unknown.
    from optimized_rag_tpu_torch.engine.types import retrieval_strategy
    strategy_k = (retrieval_strategy(state.query_intent)["top_k"]
                  if state.query_intent is not None
                  else agent.settings.retrieval.top_k)
    if agent.hierarchical is not None:
        docs, info = agent.hierarchical.retrieve(
            query, top_k=strategy_k, intent=state.query_intent,
            weights=weights,
            # Self-RAG relevance from the previous evaluation round blends
            # 60/40 into tier confidence (reference
            # hierarchical_retriever.py:86-90) so low semantic relevance
            # forces escalation raw scores alone would not.
            semantic_confidence=state.semantic_confidence)
        state.tiers_used = info["tiers_used"]
        state.retrieval_confidence = info["confidence"]
    else:
        docs = agent.retriever.retrieve(query, top_k=strategy_k,
                                        intent=state.query_intent,
                                        weights=weights)
        state.tiers_used = [2]
    # Merge archival memories into candidates (reference rerank_and_eval
    # merges archival+docs, :52-60).
    state.rag_context = docs + state.archival_memories
    if agent.kg_retriever is not None and agent.settings.flags.enable_kg:
        state.kg_context = agent.kg_retriever.query_knowledge_graph(query)
        # Composed multi-hop chains become a CITABLE evidence doc: a
        # 2-hop fact spans two documents, so no retrieved chunk can
        # support the answer — the chain sentence is the only surface
        # the generator can extract and the verifier can check.
        chains = agent.kg_retriever.query_chains(query)
        if chains:
            state.rag_context = state.rag_context + [RetrievedDoc(
                doc_id=-2, score=0.5,
                text=". ".join(chains) + ".",
                source=Source.KNOWLEDGE_GRAPH)]


def rerank_and_eval(state: AgentState, agent) -> None:
    """Selective rerank -> MMR -> Self-RAG eval -> consistency -> maybe
    re-retrieve -> compression (reference rag/nodes/rerank_and_eval.py:17-262)."""
    docs = state.rag_context
    query = state.effective_query
    if not docs:
        state.relevance_score = 0.0
        return
    from optimized_rag_tpu_torch.utils.lang import detect_language
    if detect_language(query) not in (None, "en"):
        # Cross-lingual turn whose query was NOT translated (the
        # no-translation mode, config.flags.enable_translation=0; with
        # translation on, effective_query is already English here).
        # Every signal this node gates on — cross-encoder scores,
        # lexical coverage, Self-RAG term relevance — is structurally
        # absent when the query and the corpus share no surface forms,
        # so the round-4 kill-gates below refused EVERY such turn
        # (docs/results_r5/qa_full.json *_notranslation = 0.0). Keep the
        # cross-lingually trained dense retriever's ordering, hand the
        # refusal decision to the embedding rescue channel's cosine bar
        # (agent/llm._embed_extract), and skip compression: its
        # query-relevance ranking would drop the very sentences the
        # rescue channel selects from. English turns are byte-identical.
        docs = docs[:min(5, len(docs))]
        state.rag_context = docs
        state.relevance_score = float(min(
            max((d.score for d in docs), default=0.0), 1.0))
        state.semantic_confidence = state.relevance_score
        return
    from optimized_rag_tpu_torch.engine.types import retrieval_strategy
    strategy = retrieval_strategy(state.query_intent)
    lam = 1.0 - strategy["diversity_weight"]
    fused_sim = None
    fe = getattr(agent, "fused_eval", None)
    if fe is not None:
        # One device dispatch for rerank + MMR + relevance + pairwise
        # consistency (ops/fused_eval.py) — behavior-parity with the
        # modular sequence below, minus three round trips.
        res = fe.run(query, docs, state.query_intent,
                     k_mmr=min(5, len(docs)), lam=lam)
        docs, fused_sim = res["docs"], res["sim"]
        ev = res
    else:
        docs = agent.reranker.rerank(query, docs, state.query_intent)
        docs = agent.reranker.apply_mmr(docs, k=min(5, len(docs)), lam=lam)
        ev = agent.selfrag.evaluate_retrieval(query, docs)
    state.relevance_score = ev["relevance"]
    # Carry Self-RAG relevance into later tier-confidence evaluations
    # (reference rerank_and_eval.py:197-199).
    state.semantic_confidence = ev["relevance"]

    # Zero-relevance early exit vs CROSS_ENCODER_SCORE_THRESHOLD=0.15
    # (reference :201-211). The reference trusts the raw threshold
    # because ms-marco-MiniLM sigmoid scores are calibrated to it; the
    # on-device cross-encoder is trained from scratch and scores
    # out-of-domain pairs near zero even for lexically perfect answers
    # (measured: 0.079 on a single-doc corpus whose doc contains the
    # literal answer). Require lexical corroboration before dropping
    # everything: a sub-threshold rerank where most query terms DO
    # appear in a doc is a calibration artifact, not garbage retrieval.
    thr = agent.settings.rerank.cross_encoder_threshold
    if all((d.rerank_score or d.score) < thr for d in docs) \
            and _lexical_coverage(query, docs) < 0.34:
        state.rag_context = []
        state.relevance_score = 0.0
        return

    # Lexical zero-coverage exit: when NOT ONE content word of a factual
    # query appears anywhere in the retrieved docs, the retrieval is
    # off-topic regardless of its cosine scores (an anisotropic encoder
    # scores unrelated text 0.5-0.7, so absolute-threshold gates cannot
    # catch this). Deterministic stand-in for the reference's LLM
    # retrieval-relevance judgment (rag/self_rag.py:49) feeding the same
    # early exit; measured on the QA sheet's unanswerable probes.
    if _zero_lexical_coverage(query, docs, state.query_intent):
        state.rag_context = []
        state.relevance_score = 0.0
        return

    # Re-retrieval loop with progressive top-k + RRF merge (:213-244).
    max_re = agent.settings.loops.max_reretrieve_attempts
    prog = agent.settings.loops.progressive_top_k
    while agent.selfrag.should_reretrieve(state.relevance_score,
                                          state.reretrieve_attempts, max_re):
        fused_sim = None  # docs change below; the fused matrix is stale
        state.reretrieve_attempts += 1
        k = prog[min(state.reretrieve_attempts, len(prog) - 1)]
        alt_q = agent.query_rewriter.expand_query(query)[-1]
        extra = agent.retriever.retrieve(alt_q, top_k=k,
                                         intent=state.query_intent)
        docs = agent.reranker.rrf_merge([docs, extra],
                                        k_out=max(len(docs), k))
        ev = agent.selfrag.evaluate_retrieval(query, docs)
        state.relevance_score = ev["relevance"]
        state.semantic_confidence = ev["relevance"]

    # Consistency check (:160-194). The fused dispatch already computed
    # the pairwise-cosine matrix for the selected docs; reuse it.
    if agent.settings.flags.enable_consistency_check and len(docs) > 1:
        state.consistency = agent.consistency.check_consistency(
            docs, sim=fused_sim)
        if not state.consistency["consistent"]:
            state.warnings.append(
                f"{len(state.consistency['contradictions'])} contradiction(s)"
                " across sources")

    # Compression (:246-262).
    if agent.settings.flags.enable_compression:
        docs = agent.compressor.compress(
            query, docs, intent=state.query_intent,
            confidence=state.retrieval_confidence or 1.0)
        state.compressed = True
    # Pin composed KG evidence (retrieve_rag's chain doc): it exists
    # only when the query's entities link ACROSS documents, so no
    # single retrieved chunk carries the composed fact — a reranker
    # trained on natural sentences scoring the terse triple text low
    # must not silently drop the one citable multi-hop surface. It
    # rides first so an equal-evidence tie resolves to the composed
    # chain rather than either half.
    # Membership by (doc_id, source), not object identity: the
    # compressor REBUILDS surviving docs (new RetrievedDoc objects), so
    # an id() check would re-pin a chain doc that already survived into
    # ``docs`` — duplicating its evidence and its citation number.
    kept = {(d.doc_id, d.source) for d in docs}
    kg_pinned = [d for d in state.rag_context
                 if d.source == Source.KNOWLEDGE_GRAPH
                 and (d.doc_id, d.source) not in kept]
    state.rag_context = kg_pinned + docs


def chain_of_thought(state: AgentState, agent) -> None:
    """Step-by-step reasoning over context (reference
    rag/nodes/chain_of_thought.py:17)."""
    state.cot_reasoning = agent.llm.complete(
        prompts.COT_PROMPT.format(context=_format_context(state.rag_context),
                                  query=state.effective_query), task="cot")


def synthesize_multi_doc(state: AgentState, agent) -> None:
    """Multi-doc synthesis when intent warrants and >2 docs (reference
    rag/nodes/synthesize_multi_doc.py:19)."""
    if state.query_intent in (Intent.MULTI_HOP_REASONING, Intent.COMPARISON,
                              Intent.SUMMARIZATION) \
            and len(state.rag_context) > 2 \
            and agent.settings.flags.enable_multi_doc_synthesis:
        state.synthesized_context = agent.llm.complete(
            prompts.SYNTHESIZE_PROMPT.format(
                context=_format_context(state.rag_context),
                query=state.effective_query), task="synthesize")


def generate_response(state: AgentState, agent) -> None:
    """Structured cited generation + the validation battery (reference
    rag/nodes/generate_response.py:66-441)."""
    docs = state.rag_context
    query = state.effective_query
    # Context-quality gate (:88-108).
    if not docs:
        state.response = ("I don't have enough information to answer that "
                          "reliably.")
        state.refused = True
        state.citations = []
        state.support_ratio = 0.0
        state.factuality_score = 0.0
        state.factuality_level = "poor"
        return
    context = _format_context(docs)
    # Recent conversation, truncated to its token budget (reference
    # assembles conversation into context, utils/context.py budget).
    if state.recent_messages:
        from optimized_rag_tpu_torch.utils.tokens import (
            token_budget, truncate_conversation)
        budget = token_budget(agent.settings.context.max_context_tokens,
                              agent.settings.context.allocation)
        recent = truncate_conversation(state.recent_messages[-8:],
                                       budget["conversation"], keep_first=0)
        if recent:
            convo = "\n".join(f"{m['role']}: {m['content'][:300]}"
                              for m in recent)
            context += f"\n[Conversation]\n{_neutralize_bracket_lines(convo)}"
    # Auxiliary payloads get the same bracket-line neutralization as doc
    # text: a '[N]'-at-line-start line inside them would otherwise
    # create phantom docs past the real numbered ones.
    if state.kg_context:
        context += f"\n[KG]\n{_neutralize_bracket_lines(state.kg_context)}"
    if state.cot_reasoning:
        context += ("\n[Reasoning]\n"
                    + _neutralize_bracket_lines(state.cot_reasoning))
    if state.synthesized_context:
        context += ("\n[Synthesis]\n"
                    + _neutralize_bracket_lines(state.synthesized_context))
    out = agent.llm.structured(
        prompts.GENERATE_PROMPT.format(
            core_memory=agent.memory.format_core_memory(),
            context=context, query=query),
        keys=("answer", "citations"), task="generate")
    answer = str(out.get("answer", "")).strip()
    if not answer:  # structured -> plain fallback (:201-208)
        answer = agent.llm.complete(
            prompts.GENERATE_PROMPT.format(
                core_memory="", context=context, query=query),
            task="generate")
    state.response = answer
    state.citations = sorted({int(c)
                              for c in re.findall(r"\[(\d+)\]", answer)})

    # Citation validation (:218-227).
    cval = agent.citation_validator.validate_citations(answer, len(docs))
    state.citation_valid = cval["valid"]

    # Faithfulness (:230-238).
    if agent.settings.flags.enable_self_rag:
        raw = agent.llm.complete(
            prompts.FAITHFULNESS_PROMPT.format(context=context,
                                               answer=answer),
            task="faithfulness")
        m = re.search(r"[01]?\.\d+|[01]", raw)
        state.faithfulness = float(m.group(0)) if m else 0.5

    # Claim-level factuality (:255-332).
    ev = agent.selfrag.evaluate_answer(query, answer, docs)
    state.claims = ev["claims"]
    state.support_ratio = ev["support_ratio"]
    state.uncited_ratio = ev["uncited_ratio"]
    coverage = 1.0 - state.uncited_ratio
    fact = agent.factuality.calculate(
        support_ratio=state.support_ratio, citation_coverage=coverage,
        confidence=state.intent_confidence or 0.5,
        retrieval_quality=state.relevance_score,
        citation_count=cval["citation_count"])
    state.factuality_score = fact["factuality_score"]
    state.factuality_level = fact["level"]
    if fact["should_refuse"] and agent.settings.flags.enable_factuality_scoring:
        state.refused = True
        state.response = ("I cannot answer this reliably from the available "
                          "sources (factuality "
                          f"{state.factuality_score:.2f}).")

    # Uncertainty (:369-424) + temporal + HITL.
    if agent.settings.flags.enable_uncertainty:
        unc = quantify_uncertainty(
            answer, state.faithfulness, state.factuality_score,
            cval["valid"], cval["citation_count"],
            context_sufficient=bool(docs),
            context_max_score=max((d.score for d in docs), default=0.0))
        state.uncertainty = unc["uncertainty"]
    if agent.settings.flags.enable_temporal_validation:
        tv = agent.temporal_validator.validate(answer, docs)
        state.temporal_issues = tv["issues"]
    if agent.settings.flags.enable_attribution:
        state.attribution = agent.attribution.create_attribution_map(answer,
                                                                     docs)
    if agent.settings.flags.enable_hitl and \
            0.4 <= state.factuality_score < 0.7:
        state.hitl_flagged = True  # gray zone (:390-424)
    # Cost tracking (:431-441).
    if agent.cost_tracker is not None:
        agent.cost_tracker.track_llm(len(context) // 4,
                                     len(answer) // 4)


def verify_response(state: AgentState, agent) -> None:
    """Dual-pass claim verification (reference
    rag/nodes/verify_response.py:45-245): Pass 1 ensemble/semantic,
    Pass 2 exact key-term matching; combined accept rule; pass if
    support_ratio >= MIN_SUPPORT_RATIO."""
    if state.refused or not state.response or not state.rag_context:
        state.verification_passed = state.refused
        return
    evidence = "\n".join(d.text for d in state.rag_context)
    accepted = 0
    claims = state.claims or [
        {"claim": s, "supported": None}
        for s in split_sentences(state.response)[:10]]
    # Pass 1 for any not-yet-verified claims, batched (one embedding
    # dispatch for all of them).
    pending = [c for c in claims if c.get("supported") is None]
    if pending and agent.ensemble is not None:
        verdicts = agent.ensemble.verify_claims(
            [c["claim"] for c in pending],
            [d.text for d in state.rag_context])
        for c, v in zip(pending, verdicts):
            c["supported"] = v["supported"]
    for c in claims:
        pass1 = c.get("supported")
        pass2 = exact_match_verify(
            c["claim"], evidence,
            agent.settings.verification.exact_match_term_ratio)
        # Combined accept: either pass accepts (:181-198).
        if pass1 or pass2:
            accepted += 1
    ratio = accepted / len(claims) if claims else 1.0
    state.support_ratio = max(state.support_ratio, ratio)
    state.verification_passed = (
        ratio >= agent.settings.verification.min_support_ratio)


def query_refinement(state: AgentState, agent) -> None:
    """LLM query rewrite for retry (reference
    rag/nodes/query_refinement.py:17-76)."""
    state.refinement_attempts += 1
    problems = (f"support_ratio={state.support_ratio:.2f}, "
                f"factuality={state.factuality_score:.2f}")
    refined = agent.query_rewriter.refine(state.effective_query, problems)
    if refined.strip().lower() == state.effective_query.strip().lower():
        # No-improvement early stop (:28-48).
        state.refinement_attempts = agent.settings.loops.\
            max_refinement_attempts
        return
    state.rewritten_query = refined
    state.reretrieve_attempts = 0


def web_search_fallback(state: AgentState, agent) -> None:
    """Tier-3 web augmentation when factuality is POOR, through the public
    agentic re-entry (reference rag/nodes/web_search_fallback.py:13-160
    calling tier_3_agentic_search, hierarchical_retriever.py:701; its
    trigger_tier_3 name bug is intentionally not reproduced — see
    SURVEY.md §2.1 note)."""
    state.web_search_attempted = True
    try:
        # existing_context=None: this node only fires after the context
        # failed factuality, so it must not be presented as sufficient
        # (the reference's re-entry passes score-less strings, which its
        # LLM prompt reads as score 0 — same effect).
        results = agent.tier3_agentic_search(
            state.effective_query, existing_context=None,
            intent=state.query_intent)
    except Exception as exc:
        state.warnings.append(f"web search failed: {exc}")
        return
    results = [d for d in results if d.source == Source.WEB]
    if results:
        state.web_context = results
        state.rag_context = results + state.rag_context
        state.refused = False  # give generation another chance


def process_tool_calls(state: AgentState, agent) -> None:
    """Execute LLM-requested tools from the 10-tool map (reference
    rag/nodes/process_tool_calls.py:13)."""
    for call in state.tool_calls:
        result = agent.tools.execute(call.get("name", ""),
                                     call.get("arguments", {}))
        state.tool_results.append(result)
    state.tool_calls = []


def update_memory(state: AgentState, agent) -> None:
    """Persist messages; extract durable facts into core memory (reference
    rag/nodes/update_memory.py:17-91). Memory appends serialize across
    concurrent chat turns (agent.mutate_lock) so recall ordering and the
    archival index never interleave mid-write."""
    lock = getattr(agent, "mutate_lock", None)
    ctx = lock if lock is not None else _NULL_CTX
    with ctx:
        agent.memory.save_message("user", state.user_input)
        agent.memory.save_message("assistant", state.response)
    if agent.settings.flags.enable_memory_fact_extraction \
            and state.query_intent not in (Intent.SEARCH,
                                           Intent.INSTRUCTION):
        raw = agent.llm.complete(
            prompts.FACT_EXTRACTION_PROMPT.format(
                user=state.user_input, assistant=state.response),
            task="extract_facts")
        facts = [line.strip().lstrip("-• ").strip()
                 for line in raw.splitlines()]
        with ctx:
            for fact in facts:
                if fact and fact.upper() != "NONE" and len(fact) > 5:
                    agent.memory.add_core_fact(fact)
    state.metrics["finished_at"] = time.time()
