"""Conversational agent: the orchestration shell over the device engine.

Reproduces the reference's agent layer (agent/rag_graph.py, agent/state.py,
rag/nodes/*) as a typed-state step machine with the same 16-node workflow
and its three feedback loops (regenerate / refine / web-fallback), plus the
full anti-hallucination stack. LLM access sits behind a provider interface
with a deterministic offline fake for deployments without network access.

Held against ``optimized_rag_tpu/agent/__init__.py``, a copy whose imports
name the port's modules.
"""

from optimized_rag_tpu_torch.agent.llm import (
    LLMProvider, DeterministicLLM, OpenAICompatibleLLM)
from optimized_rag_tpu_torch.agent.state import AgentState, ChatResponse
from optimized_rag_tpu_torch.agent.agent import RAGAgent
