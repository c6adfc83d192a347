"""MemGPT-style 3-part memory: core / archival / recall.

API mirror of the reference MemoryManager (memory/manager.py:21-445):
  core     — persona + human + facts blocks with append/replace/add_fact
  archival — embedded long-term memory; semantic search runs through a
             DenseIndex on the device instead of pgvector SQL
  recall   — conversation log with recency fetch and substring search

The embedding service is the on-device BiEncoder (models/encoder.py).
Held against ``optimized_rag_tpu/store/memory.py``: the archival index,
``DenseIndex(dim, capacity_block=4096, tile=1024)`` as the reference's, is
built on the manager's ``device`` unless one is passed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from optimized_rag_tpu_torch.engine.types import RetrievedDoc, Source
from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.store.db import MetadataStore

CORE_BLOCKS = ("persona", "human", "facts")


class MemoryManager:
    def __init__(self, store: MetadataStore, embed_fn: Callable,
                 agent_id: str = "default", embed_dim: int = 384,
                 persona: str = "I am a helpful research assistant.",
                 core_limit_chars: int = 4000,
                 archival_index: Optional[DenseIndex] = None,
                 device="cuda"):
        self.store = store
        self.embed_fn = embed_fn
        self.agent_id = agent_id
        self.core_limit = core_limit_chars
        self.archival = archival_index or DenseIndex(
            dim=embed_dim, capacity_block=4096, tile=1024, device=device)
        self._ensure_core_memory(persona)

    # ---------------------------------------------------------------- core

    def _ensure_core_memory(self, persona: str) -> None:
        core = self.store.get_core_memory(self.agent_id)
        if "persona" not in core:
            self.store.set_core_memory(self.agent_id, "persona", persona)
        for block in ("human", "facts"):
            if block not in core:
                self.store.set_core_memory(self.agent_id, block, "")

    def get_core_memory(self) -> Dict[str, str]:
        return self.store.get_core_memory(self.agent_id)

    def core_memory_append(self, block: str, content: str) -> str:
        cur = self.get_core_memory().get(block, "")
        new = (cur + "\n" + content).strip()
        if len(new) > self.core_limit:
            return (f"Error: block '{block}' would exceed "
                    f"{self.core_limit} chars; use core_memory_replace")
        self.store.set_core_memory(self.agent_id, block, new)
        self.store.log_memory_operation(self.agent_id,
                                        "core_memory_append", block)
        return f"Appended to core memory block '{block}'."

    def core_memory_replace(self, block: str, old: str, new: str) -> str:
        cur = self.get_core_memory().get(block, "")
        if old not in cur:
            return f"Error: '{old}' not found in block '{block}'"
        self.store.set_core_memory(self.agent_id, block,
                                   cur.replace(old, new))
        self.store.log_memory_operation(self.agent_id,
                                        "core_memory_replace", block)
        return f"Replaced in core memory block '{block}'."

    def add_core_fact(self, fact: str) -> str:
        return self.core_memory_append("facts", f"- {fact}")

    def format_core_memory(self) -> str:
        core = self.get_core_memory()
        return "\n".join(f"<{b}>\n{core.get(b, '')}\n</{b}>"
                         for b in CORE_BLOCKS)

    # ------------------------------------------------------------- archival

    def archival_memory_insert(self, content: str,
                               metadata: Optional[Dict] = None) -> int:
        emb = np.atleast_2d(self.embed_fn([content]))
        ids = self.archival.add(emb)
        self.store.insert_archival(self.agent_id, int(ids[0]), content,
                                   metadata)
        self.store.log_memory_operation(self.agent_id,
                                        "archival_memory_insert")
        return int(ids[0])

    def bulk_insert_archival(self, contents: List[str]) -> List[int]:
        if not contents:
            return []
        emb = np.atleast_2d(self.embed_fn(contents))
        ids = self.archival.add(emb)
        for i, c in zip(ids, contents):
            self.store.insert_archival(self.agent_id, int(i), c)
        return [int(i) for i in ids]

    def archival_memory_search(self, query: str, top_k: int = 5
                               ) -> List[RetrievedDoc]:
        if self.archival.size == 0:
            return []
        q = np.atleast_2d(self.embed_fn([query]))
        res = self.archival.search(q, k=min(top_k, self.archival.size))
        out = []
        for score, did in zip(res.scores[0], res.ids[0]):
            if did < 0:
                continue
            out.append(RetrievedDoc(
                doc_id=int(did), score=float(score),
                text=self.store.archival_text(int(did)),
                source=Source.ARCHIVAL,
                created_at=self.store.archival_created_at(int(did))))
        return out

    # --------------------------------------------------------------- recall

    def save_message(self, role: str, content: str) -> int:
        return self.store.save_message(self.agent_id, role, content)

    def get_recent_messages(self, limit: int = 10) -> List[Dict]:
        return self.store.get_recent_messages(self.agent_id, limit)

    def conversation_search(self, query: str, limit: int = 10) -> List[Dict]:
        return self.store.conversation_search(self.agent_id, query, limit)
