"""Pipeline node bodies (reference rag/nodes/__init__.py:40-77 exports
16 node functions + 5 decision functions; same surface here).

Held against ``optimized_rag_tpu/agent/nodes/__init__.py``, a copy whose
imports name the port's modules.
"""

from optimized_rag_tpu_torch.agent.nodes.core import (
    receive_input, recognize_intent, rewrite_query, retrieve_memory,
    route_query, check_context, retrieve_rag, rerank_and_eval,
    chain_of_thought, synthesize_multi_doc, generate_response,
    verify_response, query_refinement, web_search_fallback,
    process_tool_calls, update_memory)
from optimized_rag_tpu_torch.agent.nodes.decisions import (
    should_use_cot, should_regenerate, decide_next_action,
    should_try_web_search, should_refine_query)
