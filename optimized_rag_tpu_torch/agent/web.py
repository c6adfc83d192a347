"""Web search with provider fallback chain.

Re-implements rag/web_search.py:12-150 (Tavily-first, DuckDuckGo fallback,
fail-open). Providers activate only when their client library + API key
exist; a ``search_fn`` can be injected for tests/offline use. Without a
provider the default instance is a no-op that the tier-3 path treats as
"web unavailable".

Held against ``optimized_rag_tpu/agent/web.py``, a copy whose imports name
the port's modules.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

from optimized_rag_tpu_torch.engine.types import RetrievedDoc, Source


class WebSearchTool:
    def __init__(self, search_fn: Optional[Callable] = None,
                 max_results: int = 5, cost_tracker=None):
        self.search_fn = search_fn
        self.max_results = max_results
        self.cost_tracker = cost_tracker
        self._providers = []
        if search_fn is None:
            self._init_providers()

    @property
    def available(self) -> bool:
        return self.search_fn is not None or bool(self._providers)

    def _init_providers(self) -> None:
        try:  # Tavily first (reference :104)
            from tavily import TavilyClient  # type: ignore
            key = os.environ.get("TAVILY_API_KEY")
            if key:
                client = TavilyClient(api_key=key)
                self._providers.append(
                    ("tavily", lambda q, n: [
                        {"title": r.get("title", ""),
                         "content": r.get("content", ""),
                         "url": r.get("url", "")}
                        for r in client.search(q, max_results=n)
                        .get("results", [])]))
        except ImportError:
            pass
        try:  # DuckDuckGo fallback (reference :131)
            from duckduckgo_search import DDGS  # type: ignore
            self._providers.append(
                ("ddg", lambda q, n: [
                    {"title": r.get("title", ""),
                     "content": r.get("body", ""),
                     "url": r.get("href", "")}
                    for r in DDGS().text(q, max_results=n)]))
        except ImportError:
            pass

    def search(self, query: str, max_results: Optional[int] = None
               ) -> List[RetrievedDoc]:
        n = max_results or self.max_results
        raw: List[Dict] = []
        if self.search_fn is not None:
            raw = self.search_fn(query, n) or []
        else:
            for name, fn in self._providers:
                try:
                    raw = fn(query, n) or []
                    if raw:
                        break
                except Exception:
                    continue  # fall through the chain (reference :88-101)
        if raw and self.cost_tracker is not None:
            self.cost_tracker.track_search(1)
        return [RetrievedDoc(
            doc_id=-(2000 + i), score=max(0.9 - 0.1 * i, 0.1),
            text=f"{r.get('title', '')}: {r.get('content', '')}".strip(": "),
            source=Source.WEB, metadata={"url": r.get("url", "")})
            for i, r in enumerate(raw[:n])]
