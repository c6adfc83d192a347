"""The PyTorch port's HTTP server against the JAX package's, on the CPU.

Every case of ``tests/test_server.py`` runs against both servers, each over
its own package's agent built the same way (``FakeEmbedder(dim=32)``,
``FakeCrossEncoder``, an offline web tool, one document, the port at
``device="cpu"``), and the two replies are held field by field: status
codes, error strings and JSON keys equal, ids and texts equal, scores
within 1e-5, and fields that time the host (``latency_s``, queue waits)
left out. ``/healthz`` says ``"cpu"`` in both. ``time.time`` is pinned and
both analyzers run their Python paths, as in ``tests/test_torch_agent.py``.
Then ``concurrent_chat``: four turns at once behind the semaphore, their
embeddings coalesced by the agent's ``EmbedBatcher``; and 64 clients
connecting at once, which the port's listen backlog of 128 holds.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import optimized_rag_tpu.native as jax_native
from optimized_rag_tpu.agent.agent import RAGAgent as JaxAgent
from optimized_rag_tpu.agent.llm import DeterministicLLM as JaxLLM
from optimized_rag_tpu.agent.web import WebSearchTool as JaxWeb
from optimized_rag_tpu.config import Settings as JaxSettings
from optimized_rag_tpu.server import AgentHTTPServer as JaxServer
from optimized_rag_tpu_torch import native
from optimized_rag_tpu_torch.agent.agent import RAGAgent
from optimized_rag_tpu_torch.agent.llm import DeterministicLLM
from optimized_rag_tpu_torch.agent.web import WebSearchTool
from optimized_rag_tpu_torch.config import Settings
from optimized_rag_tpu_torch.server import AgentHTTPServer

from fakes import FakeCrossEncoder, FakeEmbedder

torch.set_num_threads(2)

NOW = 1_790_000_000.0
SCORE_TOL = 1e-5
TIMING = ("latency_s", "wait_ms_sum", "avg_queue_wait_ms")
DOC = ("The MXU is a 128x128 systolic array. It multiplies matrices in "
       "bfloat16 precision on the TPU.")
CHAT_FIELDS = {"answer", "citations", "sources", "confidence",
               "factuality_score", "support_ratio", "refused", "intent",
               "tiers_used", "warnings", "metrics"}


@pytest.fixture(autouse=True)
def hermetic(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_load_attempted", True)
    for name in ("term_counts", "model_tokenize", "vocab_tokenize"):
        monkeypatch.setattr(native, name, lambda *args: None)


def _serve(pkg, tmp_path, concurrent=False):
    jax = pkg == "jax"
    s = JaxSettings() if jax else Settings()
    s.data_dir = str(tmp_path / pkg)
    s.flags.enable_metrics_export = False
    s.serving.concurrent_chat = concurrent
    llm, web = (JaxLLM, JaxWeb) if jax else (DeterministicLLM, WebSearchTool)
    a = (JaxAgent if jax else RAGAgent)(
        s, llm=llm(), embed_service=FakeEmbedder(dim=32),
        cross_encoder=FakeCrossEncoder(),
        web=web(search_fn=lambda q, n: []),
        **({} if jax else {"device": "cpu"}))
    a.ingestor.ingest_text(DOC, filename="tpu.txt")
    srv = (JaxServer if jax else AgentHTTPServer)(a, port=0)
    return srv, srv.start()


@pytest.fixture
def servers(tmp_path):
    """(JAX server, its port), (the port's server, its port)."""
    pair = [_serve(pkg, tmp_path) for pkg in ("jax", "port")]
    yield pair
    for srv, _ in pair:
        srv.stop()


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _split(obj, path=""):
    """(everything but floats and timings, {path: float}) of a JSON value."""
    if isinstance(obj, dict):
        exact, nums = {}, {}
        for k, v in obj.items():
            if k in TIMING:
                continue
            exact[k], sub = _split(v, f"{path}.{k}")
            nums.update(sub)
        return exact, nums
    if isinstance(obj, list):
        exact, nums = [], {}
        for j, v in enumerate(obj):
            e, sub = _split(v, f"{path}[{j}]")
            exact.append(e)
            nums.update(sub)
        return exact, nums
    if isinstance(obj, float):
        return "<float>", {path: obj}
    return obj, {}


def _same(got, want):
    """Two replies: (code, JSON) equal, floats within SCORE_TOL."""
    assert got[0] == want[0], (got, want)
    (e_g, n_g), (e_w, n_w) = _split(got[1]), _split(want[1])
    assert e_g == e_w, (got, want)
    assert n_g.keys() == n_w.keys()
    for key in n_w:
        assert abs(n_g[key] - n_w[key]) <= SCORE_TOL, (key, n_g[key],
                                                       n_w[key])


def test_healthz_and_stats_match_jax(servers):
    (_, pj), (_, pp) = servers
    got, want = _get(pp, "/healthz"), _get(pj, "/healthz")
    _same(got, want)
    assert got == (200, {"ok": True, "backend": "cpu", "corpus_size": 1})
    got, want = _get(pp, "/stats"), _get(pj, "/stats")
    _same(got, want)
    assert got[0] == 200 and "serving" in got[1] and "rerank" in got[1]


@pytest.mark.parametrize("query,k", [("systolic array matrices", 3),
                                     ("bfloat16 precision", 10),
                                     ("  padded query  ", 1)])
def test_search_endpoint_matches_jax(servers, query, k):
    (_, pj), (_, pp) = servers
    got = _post(pp, "/search", {"query": query, "k": k})
    _same(got, _post(pj, "/search", {"query": query, "k": k}))
    assert got[0] == 200 and got[1]["results"]
    if "systolic" in query:
        assert "systolic" in got[1]["results"][0]["text"]


def test_search_micro_batches_concurrent_callers_match_jax(servers):
    replies = {}
    for (srv, port), pkg in zip(servers, ("jax", "port")):
        out = replies[pkg] = [None] * 8

        def call(i, port=port, out=out):
            out[i] = _post(port, "/search",
                           {"query": f"systolic array {i}", "k": 2})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert all(r[0] == 200 for r in out)
        stats = srv.query_server.get_stats()
        assert stats["queries"] >= 8
        assert stats["batches"] <= stats["queries"]
    for got, want in zip(replies["port"], replies["jax"]):
        _same(got, want)


@pytest.mark.parametrize("message", ["What is the MXU?",
                                     "Is the MXU a systolic array?"])
def test_chat_endpoint_matches_jax(servers, message):
    (_, pj), (_, pp) = servers
    got = _post(pp, "/chat", {"message": message})
    _same(got, _post(pj, "/chat", {"message": message}))
    assert got[0] == 200 and got[1]["answer"]
    assert set(got[1]) == CHAT_FIELDS


@pytest.mark.parametrize("path,payload", [
    ("/search", {}), ("/search", {"query": "   "}), ("/chat", {}),
    ("/nope", {"x": 1}), ("/search", {"query": "x", "k": "many"})])
def test_bad_requests_match_jax(servers, path, payload):
    (_, pj), (_, pp) = servers
    got = _post(pp, path, payload)
    _same(got, _post(pj, path, payload))
    assert got[0] in (400, 404)


def test_get_errors_return_json_500_match_jax(servers):
    """do_GET fails open as do_POST does: a stats provider's failure comes
    back as a JSON 500 in both packages, and an unknown path as a 404."""

    class Boom:
        def get_statistics(self):
            raise RuntimeError("stats provider exploded")

    replies = []
    for srv, port in servers:
        old = srv.agent.hierarchical
        srv.agent.hierarchical = Boom()
        try:
            replies.append((_get(port, "/stats"), _get(port, "/nope")))
        finally:
            srv.agent.hierarchical = old
    (s_j, n_j), (s_p, n_p) = replies
    _same(s_p, s_j)
    _same(n_p, n_j)
    assert s_p[0] == 500 and "exploded" in s_p[1]["error"]
    assert n_p == (404, {"error": "unknown path"})


def test_concurrent_chat_coalesces_embeddings(tmp_path):
    """With ``concurrent_chat`` the chat lock is a semaphore of
    ``max_concurrent_turns`` and the agent's embeddings go through its
    EmbedBatcher: four turns at once all answer with every field, and the
    batcher sees every embedding request."""
    srv, port = _serve("port", tmp_path, concurrent=True)
    try:
        agent = srv.agent
        assert isinstance(srv._chat_lock, threading.Semaphore)
        assert agent.embed_fn == agent.embed_batcher.encode
        before = dict(agent.embed_batcher.stats)
        out = [None] * 4

        def call(i):
            out[i] = _post(port, "/chat",
                           {"message": f"What does the MXU multiply? ({i})"})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for code, body in out:
            assert code == 200 and set(body) == CHAT_FIELDS
            assert body["answer"] and np.isfinite(body["confidence"])
        stats = agent.embed_batcher.stats
        requests = stats["requests"] - before["requests"]
        assert requests >= 4
        assert 0 < stats["dispatches"] - before["dispatches"] <= requests
    finally:
        srv.stop()
        srv.agent.embed_batcher.stop()


class _SlowEmbedder(FakeEmbedder):
    """FakeEmbedder that takes 50 ms a call, as an encoder forward does."""

    def __call__(self, texts):
        time.sleep(0.05)
        return super().__call__(texts)


def test_many_clients_connecting_at_once_are_all_answered(tmp_path):
    """64 clients at once while batches run: the listen backlog holds them
    (socketserver's default of 5 reset some connections)."""
    from concurrent.futures import ThreadPoolExecutor
    s = Settings()
    s.data_dir = str(tmp_path / "port")
    s.flags.enable_metrics_export = False
    a = RAGAgent(s, llm=DeterministicLLM(),
                 embed_service=_SlowEmbedder(dim=32),
                 cross_encoder=FakeCrossEncoder(),
                 web=WebSearchTool(search_fn=lambda q, n: []), device="cpu")
    a.ingestor.ingest_text(DOC, filename="tpu.txt")
    srv = AgentHTTPServer(a, port=0)
    port = srv.start()
    try:
        with ThreadPoolExecutor(64) as pool:
            codes = list(pool.map(lambda i: _post(
                port, "/search", {"query": f"systolic {i}", "k": 1})[0],
                range(256)))
        assert codes == [200] * 256
        assert srv._httpd.request_queue_size >= 64
    finally:
        srv.stop()
