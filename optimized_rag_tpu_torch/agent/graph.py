"""Minimal typed-state step machine (LangGraph-equivalent control).

The reference compiles a LangGraph StateGraph (agent/rag_graph.py:319-418).
This is the same model — named nodes, static edges, conditional edges with
a decision function — as ~60 lines of dependency-free host code. Nodes
mutate the AgentState in place; the engine does all device compute.

Held against ``optimized_rag_tpu/agent/graph.py``, a copy whose imports
name the port's modules.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

END = "__end__"


class StateGraph:
    def __init__(self, max_steps: int = 64):
        self._nodes: Dict[str, Callable] = {}
        self._edges: Dict[str, str] = {}
        self._conditional: Dict[str, tuple] = {}
        self._entry: Optional[str] = None
        self.max_steps = max_steps

    def add_node(self, name: str, fn: Callable) -> "StateGraph":
        assert name not in self._nodes, f"duplicate node {name}"
        self._nodes[name] = fn
        return self

    def set_entry(self, name: str) -> "StateGraph":
        self._entry = name
        return self

    def add_edge(self, src: str, dst: str) -> "StateGraph":
        self._edges[src] = dst
        return self

    def add_conditional(self, src: str, decide: Callable,
                        mapping: Dict[str, str]) -> "StateGraph":
        self._conditional[src] = (decide, mapping)
        return self

    def compile(self) -> "CompiledGraph":
        assert self._entry, "entry node not set"
        for src, dst in self._edges.items():
            assert src in self._nodes, src
            assert dst == END or dst in self._nodes, dst
        for src, (_, mapping) in self._conditional.items():
            assert src in self._nodes, src
            for dst in mapping.values():
                assert dst == END or dst in self._nodes, dst
        return CompiledGraph(self)


class CompiledGraph:
    def __init__(self, spec: StateGraph):
        self.spec = spec

    def invoke(self, state, trace: Optional[list] = None):
        node = self.spec._entry
        steps = 0
        while node != END:
            if steps >= self.spec.max_steps:
                raise RuntimeError(
                    f"graph exceeded {self.spec.max_steps} steps "
                    f"(stuck at {node})")
            steps += 1
            if trace is not None:
                trace.append(node)
            self.spec._nodes[node](state)
            if node in self.spec._conditional:
                decide, mapping = self.spec._conditional[node]
                choice = decide(state)
                node = mapping[choice]
            else:
                node = self.spec._edges.get(node, END)
        return state
