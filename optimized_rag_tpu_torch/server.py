"""HTTP serving surface over the agent + micro-batched retrieval.

Held against ``optimized_rag_tpu/server.py``: the same endpoints, JSON,
status codes and error strings. Stdlib-only (http.server):

  POST /search  {"query": str, "k": int}        -> scores/ids/texts
                (micro-batched through serving.QueryServer: concurrent
                 callers coalesce into one embed + one top-k search)
  POST /chat    {"message": str}                -> full ChatResponse
                (serialized behind a lock: one agent graph instance)
  GET  /healthz                                  -> liveness + backend
  GET  /stats                                    -> tiers/rerank/serving

``/healthz``'s ``backend`` is the agent's device type ("cuda" or "cpu").
The listening socket's backlog is 128 connections, not socketserver's 5:
with 5, clients connecting at once while a batch runs were reset.

Run: python -m optimized_rag_tpu_torch serve --port 8080
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from optimized_rag_tpu_torch.serving import QueryServer


class _HTTPServer(ThreadingHTTPServer):
    # The QueryServer batches up to 64 queries: at least that many clients
    # must be able to wait in the listen backlog.
    request_queue_size = 128


class AgentHTTPServer:
    def __init__(self, agent, host: str = "127.0.0.1", port: int = 8080,
                 max_batch: int = 64, max_wait_ms: float = 5.0):
        self.agent = agent
        self.host = host
        self.port = port
        # Single-user parity default: one chat turn at a time. With
        # settings.serving.concurrent_chat the lock widens to a bounded
        # semaphore and per-turn embedding dispatches coalesce through
        # the agent's EmbedBatcher (serving.py).
        sv = getattr(agent.settings, "serving", None)
        if sv is not None and sv.concurrent_chat:
            self._chat_lock = threading.Semaphore(
                max(1, sv.max_concurrent_turns))
        else:
            self._chat_lock = threading.Lock()
        self.query_server = QueryServer(agent.embed_fn, agent.dense,
                                        max_batch=max_batch,
                                        max_wait_ms=max_wait_ms)
        self._httpd: Optional[_HTTPServer] = None

    # ------------------------------------------------------------ handlers

    def _search(self, body: dict) -> dict:
        query = str(body.get("query", "")).strip()
        if not query:
            raise ValueError("missing 'query'")
        k = max(1, min(int(body.get("k", 10)),
                       self.query_server.max_k))
        scores, ids = self.query_server.search(query, k=k)
        out = []
        for s, i in zip(scores.tolist(), ids.tolist()):
            if i < 0:
                continue
            out.append({"doc_id": int(i), "score": float(s),
                        "text": self.agent.store.chunk_text(int(i))})
        return {"results": out}

    def _chat(self, body: dict) -> dict:
        message = str(body.get("message", "")).strip()
        if not message:
            raise ValueError("missing 'message'")
        with self._chat_lock:
            resp = self.agent.chat(message)
        return {
            "answer": resp.answer, "citations": resp.citations,
            "sources": resp.sources, "confidence": resp.confidence,
            "factuality_score": resp.factuality_score,
            "support_ratio": resp.support_ratio, "refused": resp.refused,
            "intent": resp.intent, "tiers_used": resp.tiers_used,
            "warnings": resp.warnings, "metrics": resp.metrics,
        }

    def _stats(self) -> dict:
        out = {"serving": self.query_server.get_stats(),
               "rerank": self.agent.reranker.stats,
               "corpus_size": self.agent.dense.size}
        if self.agent.hierarchical is not None:
            out["tiers"] = self.agent.hierarchical.get_statistics()
        if self.agent.cost_tracker is not None:
            out["cost"] = self.agent.cost_tracker.get_summary()
        return out

    # ------------------------------------------------------------- plumbing

    def _make_handler(self):
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet; stats cover observability
                pass

            def _reply(self, code: int, payload: dict) -> None:
                raw = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                try:
                    if self.path == "/healthz":
                        self._reply(200, {
                            "ok": True,
                            "backend": srv.agent.device.type,
                            "corpus_size": srv.agent.dense.size})
                    elif self.path == "/stats":
                        self._reply(200, srv._stats())
                    else:
                        self._reply(404, {"error": "unknown path"})
                except Exception as exc:  # fail-open per request, as POST
                    self._reply(500, {"error": str(exc)})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                    if self.path == "/search":
                        self._reply(200, srv._search(body))
                    elif self.path == "/chat":
                        self._reply(200, srv._chat(body))
                    else:
                        self._reply(404, {"error": "unknown path"})
                except ValueError as exc:
                    self._reply(400, {"error": str(exc)})
                except Exception as exc:  # fail-open per request
                    self._reply(500, {"error": str(exc)})

        return Handler

    def start(self) -> int:
        """Bind and serve on a background thread; returns the bound port."""
        self.query_server.start()
        self._httpd = _HTTPServer((self.host, self.port),
                                  self._make_handler())
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self.port

    def serve_forever(self) -> None:
        self.query_server.start()
        self._httpd = _HTTPServer((self.host, self.port),
                                  self._make_handler())
        self.port = self._httpd.server_address[1]
        self._httpd.serve_forever()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.query_server.stop()
