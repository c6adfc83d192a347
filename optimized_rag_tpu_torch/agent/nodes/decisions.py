"""Conditional-edge decision functions (reference rag/nodes/decisions.py).

Priority in decide_next_action: tools > web_search > refine > continue
(reference :52-75).

Held against ``optimized_rag_tpu/agent/nodes/decisions.py``, a copy whose
imports name the port's modules.
"""

from __future__ import annotations

from optimized_rag_tpu_torch.agent.state import AgentState
from optimized_rag_tpu_torch.engine.types import Intent

COT_WORD_COUNT_THRESHOLD = 15


def should_use_cot(state: AgentState, agent) -> str:
    """reference :14-50: multi-hop/comparison intents, or multi-question
    long queries."""
    if not agent.settings.flags.enable_cot:
        return "skip"
    if state.query_intent in (Intent.COMPARISON, Intent.MULTI_HOP_REASONING):
        return "cot"
    q = state.user_input
    if q.count("?") > 1 and len(q.split()) > COT_WORD_COUNT_THRESHOLD:
        return "cot"
    return "skip"


def should_regenerate(state: AgentState, agent) -> str:
    """reference verify_response.py:248: regen while support below the
    threshold, capped at MAX_REGENERATION_ATTEMPTS (=1)."""
    caps = agent.settings.loops
    if state.refused:
        return "accept"
    if state.support_ratio < agent.settings.verification.min_support_ratio \
            and state.regeneration_attempts < caps.max_regeneration_attempts:
        state.regeneration_attempts += 1
        return "regenerate"
    return "accept"


def should_try_web_search(state: AgentState, agent) -> str:
    """reference :78-165: factuality POOR (<0.35), support 0, or refusal —
    once per session, only if web search exists."""
    if not agent.settings.flags.enable_web_search_fallback:
        return "continue"
    if state.web_search_attempted:
        return "continue"
    if agent.web is None or not agent.web.available:
        return "continue"
    trigger = (
        state.factuality_score <
        agent.settings.verification.web_search_factuality_trigger
        or state.support_ratio == 0.0
        or state.refused)
    return "web_search" if trigger else "continue"


def should_refine_query(state: AgentState, agent) -> str:
    """reference :167: refine while verification fails, capped."""
    caps = agent.settings.loops
    if not state.verification_passed and not state.refused \
            and state.refinement_attempts < caps.max_refinement_attempts \
            and state.rag_context:
        return "refine"
    return "continue"


def decide_next_action(state: AgentState, agent) -> str:
    if state.tool_calls:
        return "tools"
    if should_try_web_search(state, agent) == "web_search":
        return "web_search"
    if should_refine_query(state, agent) == "refine":
        return "refine"
    return "continue"
