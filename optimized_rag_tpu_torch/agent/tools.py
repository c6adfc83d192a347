"""LLM-callable tools: 6 memory tools + 4 RAG tools.

Mirrors the reference's tool surface:
  * agent/tools.py:13 — core_memory_append, core_memory_replace,
    archival_memory_insert, archival_memory_search, conversation_search,
    add_core_fact
  * agent/rag_tools.py:9 — upload_document, search_documents,
    list_documents, web_search

Each tool is a (name, description, schema, fn) record so any
function-calling LLM provider can expose them; ``execute`` runs a parsed
tool call and always returns a string (fail-open).

Held against ``optimized_rag_tpu/agent/tools.py``, a copy whose imports
name the port's modules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List


@dataclasses.dataclass
class Tool:
    name: str
    description: str
    parameters: Dict[str, str]
    fn: Callable[..., str]


class ToolRegistry:
    def __init__(self):
        self._tools: Dict[str, Tool] = {}

    def register(self, tool: Tool) -> None:
        self._tools[tool.name] = tool

    def get(self, name: str) -> Tool | None:
        return self._tools.get(name)

    def specs(self) -> List[Dict]:
        return [{"name": t.name, "description": t.description,
                 "parameters": t.parameters} for t in self._tools.values()]

    def execute(self, name: str, arguments: Dict[str, Any]) -> str:
        tool = self._tools.get(name)
        if tool is None:
            return f"Error: unknown tool '{name}'"
        try:
            return str(tool.fn(**arguments))
        except Exception as exc:
            return f"Error executing {name}: {exc}"


def create_memory_tools(memory) -> List[Tool]:
    """memory: store.memory.MemoryManager (reference agent/tools.py:13)."""
    return [
        Tool("core_memory_append",
             "Append content to a core memory block (persona/human/facts).",
             {"block": "string", "content": "string"},
             memory.core_memory_append),
        Tool("core_memory_replace",
             "Replace text inside a core memory block.",
             {"block": "string", "old": "string", "new": "string"},
             memory.core_memory_replace),
        Tool("archival_memory_insert",
             "Store a fact in long-term archival memory.",
             {"content": "string"},
             lambda content: f"Stored archival memory "
                             f"#{memory.archival_memory_insert(content)}"),
        Tool("archival_memory_search",
             "Semantic search over archival memory.",
             {"query": "string"},
             lambda query: "\n".join(
                 f"[{d.score:.2f}] {d.text}"
                 for d in memory.archival_memory_search(query))
             or "No archival memories found."),
        Tool("conversation_search",
             "Search past conversation messages.",
             {"query": "string"},
             lambda query: "\n".join(
                 f"{m['role']}: {m['content']}"
                 for m in memory.conversation_search(query))
             or "No matching messages."),
        Tool("add_core_fact",
             "Add a durable fact about the user to core memory.",
             {"fact": "string"}, memory.add_core_fact),
    ]


def create_rag_tools(ingestor, retriever, web: "WebSearchTool | None" = None
                     ) -> List[Tool]:
    """ingestor: services.DocumentIngestor; retriever: HybridRetriever
    (reference agent/rag_tools.py:9)."""
    tools = [
        Tool("upload_document",
             "Ingest a document file into the knowledge base.",
             {"path": "string"},
             lambda path: str(ingestor.upload_file(path))),
        Tool("search_documents",
             "Search the document knowledge base.",
             {"query": "string"},
             lambda query: "\n".join(
                 f"[{d.score:.2f}] {d.text[:200]}"
                 for d in retriever.retrieve(query, top_k=5))
             or "No documents found."),
        Tool("list_documents",
             "List ingested documents.",
             {},
             lambda: "\n".join(
                 f"#{d['id']} {d['filename'] or d['title']}"
                 f" ({d['num_chunks']} chunks)"
                 for d in ingestor.list_documents()) or "No documents."),
    ]
    if web is not None:
        tools.append(Tool(
            "web_search", "Search the web for fresh information.",
            {"query": "string"},
            lambda query: "\n".join(d.text[:200]
                                    for d in web.search(query))
            or "No web results."))
    return tools
