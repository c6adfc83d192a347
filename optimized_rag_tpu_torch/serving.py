"""Micro-batching query executor and the embedding dispatch coalescer.

Held against ``optimized_rag_tpu/serving.py``. ``EmbedBatcher`` (:63-183)
coalesces concurrent encode calls into one dispatch: the first request
dispatches at once, and whatever arrives while a dispatch runs rides the
next one. Its worker thread issues the device work on its own thread's
current stream; the result is a host copy (numpy), so a caller needs no
synchronisation. ``QueryServer`` (:185-373):
concurrent callers enqueue queries; one collector thread coalesces them
into batches; a small dispatch pool runs each batch as one batched embed
plus one batched top-k search. The collector emits a batch when it is full,
or when the wait deadline passes with no dispatch in flight; batches and k
are padded to powers of two; the bounded hand-off queue gives the collector
backpressure. All threads are daemons, and ``stop()`` joins them.

While a profiler session is active (``utils.profiling.span``) the server
records ``serve.collect`` (first request taken to batch emitted),
``serve.handoff`` (emitted to taken by a worker, the backpressure
included), ``serve.dispatch`` (the batch on its worker, with the requests'
queue waits) and ``serve.settle`` (the futures settled, callers' callbacks
inline); a batch's id is on the first three, and its ``encode`` and
``search`` spans lie under its ``serve.dispatch``.

Usage:
    server = QueryServer(embed_fn, index, max_batch=64, max_wait_ms=5)
    server.start()
    fut = server.submit("some query", k=10)
    scores, ids = fut.result()
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from optimized_rag_tpu_torch.utils.profiling import detached, span


@dataclass
class _Request:
    query: str
    k: int
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.perf_counter)


@dataclass
class _EmbedReq:
    texts: List[str]
    future: Future = field(default_factory=Future)


class EmbedBatcher:
    """Dispatch-coalescing front for an encode function.

    N concurrent chat turns each fire small embedding dispatches (claim
    verification is the big one: per-turn claims+evidence batch,
    reference ensemble_verifier.py:237). Uncoordinated, they serialize on
    the device one round trip each. This front coalesces: the first
    request dispatches immediately (zero added latency for a single
    user); everything that arrives while a dispatch is in flight is
    concatenated into the NEXT dispatch — so at saturation N turns pay
    ~1 round trip instead of N, with no grace-timer latency at all.

    Thread-safe; call ``encode(texts)`` exactly like the underlying
    service. ``stats`` records the coalescing achieved.
    """

    def __init__(self, encode_fn: Callable[[List[str]], np.ndarray],
                 max_texts: int = 256):
        self.encode_fn = encode_fn
        self.max_texts = max_texts
        self._q: "queue.Queue[Optional[_EmbedReq]]" = queue.Queue()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.stats = {"dispatches": 0, "requests": 0, "texts": 0,
                      "max_coalesced": 0}

    def start(self) -> "EmbedBatcher":
        if not self._running:
            self._running = True
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        self._q.put(None)
        if self._thread:
            self._thread.join(timeout=5)

    def encode(self, texts: List[str]) -> np.ndarray:
        if not self._running:        # transparent pass-through when off
            return self.encode_fn(texts)
        req = _EmbedReq(list(texts))
        self._q.put(req)
        try:
            # Bounded wait: generous enough for a first call that builds
            # the kernels, but a stop() racing this enqueue (request put
            # after the drain) must not hang the caller forever — fall back
            # to a direct call.
            return req.future.result(timeout=600.0)
        except TimeoutError:
            return self.encode_fn(texts)

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as exc:  # worker death must not strand callers
            self._running = False
            while True:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                if req is not None and not req.future.done():
                    req.future.set_exception(
                        RuntimeError(f"EmbedBatcher worker died: {exc!r}"))
            raise

    def _loop_inner(self) -> None:
        while self._running:
            first = self._q.get()
            if first is None:
                break
            batch = [first]
            n_texts = len(first.texts)
            # Coalesce whatever is already waiting (arrived while the
            # previous dispatch ran) up to the text cap.
            while n_texts < self.max_texts:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._running = False
                    break
                batch.append(nxt)
                n_texts += len(nxt.texts)
            all_texts = [t for r in batch for t in r.texts]
            try:
                emb = np.atleast_2d(self.encode_fn(all_texts))
                off = 0
                for r in batch:
                    out = emb[off:off + len(r.texts)]
                    off += len(r.texts)
                    try:
                        r.future.set_result(out)
                    except InvalidStateError:
                        pass
            except Exception as exc:
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(exc)
            self.stats["dispatches"] += 1
            self.stats["requests"] += len(batch)
            self.stats["texts"] += len(all_texts)
            self.stats["max_coalesced"] = max(self.stats["max_coalesced"],
                                              len(batch))
        # Drain anything left after stop so callers never hang; a
        # descriptive error beats a bare CancelledError for the racing
        # enqueuer.
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                req.future.set_exception(
                    RuntimeError("EmbedBatcher stopped while the request "
                                 "was queued; retry or call the encode "
                                 "function directly"))


class QueryServer:
    def __init__(self, embed_fn: Callable[[List[str]], np.ndarray],
                 index, max_batch: int = 64, max_wait_ms: float = 5.0,
                 max_k: int = 100, workers: int = 2):
        self.embed_fn = embed_fn
        self.index = index            # anything with .search(q_batch, k)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.max_k = max_k
        self.workers = workers
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._batches: "queue.Queue[Optional[tuple]]" = \
            queue.Queue(maxsize=max(workers, 1))
        self._threads: List[threading.Thread] = []
        self._running = False
        self._inflight = 0
        self._batch_ids = itertools.count()
        self._stats_lock = threading.Lock()
        self.stats = {"batches": 0, "queries": 0, "max_batch_seen": 0,
                      "wait_ms_sum": 0.0}

    # ---------------------------------------------------------------- API

    def start(self) -> None:
        assert not self._running
        # Fresh queues: a previous stop() leaves sentinels behind, which
        # would kill restarted threads immediately.
        self._q = queue.Queue()
        self._batches = queue.Queue(maxsize=max(self.workers, 1))
        self._running = True
        # Threads capture THEIR queues as arguments: a worker that
        # outlives a 5 s join timeout must keep draining its own epoch's
        # queue, never the replacement created by a later start().
        self._threads = [threading.Thread(
            target=self._collector_loop, args=(self._q, self._batches),
            daemon=True)]
        self._threads += [threading.Thread(
            target=self._dispatch_loop, args=(self._batches,),
            daemon=True) for _ in range(self.workers)]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._running = False
        self._q.put(None)             # collector exits, then fans out
        for t in self._threads:
            t.join(timeout=5)

    def submit(self, query: str, k: int = 10) -> Future:
        assert self._running, "server not started"
        if not 1 <= int(k) <= self.max_k:
            raise ValueError(f"k={k} out of range [1, {self.max_k}]")
        req = _Request(query=query, k=k)
        self._q.put(req)
        # stop() racing this enqueue: the collector's final drain may
        # already have finished when the put lands, leaving the future
        # unsettled forever (the documented fut.result() has no
        # timeout). If the server stopped and the request is still
        # cancellable it was missed — fail the caller fast. A cancel
        # that loses (request already collected in-flight) means the
        # dispatch will settle the future normally.
        if not self._running and req.future.cancel():
            raise RuntimeError("server stopped during submit")
        return req.future

    def search(self, query: str, k: int = 10, timeout: float = 30.0):
        return self.submit(query, k).result(timeout=timeout)

    # ------------------------------------------------------------- internal

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, max(self.max_batch, n))

    def _collect(self, q, bid: int) -> List[_Request]:
        """Block for the first request, then coalesce.

        Emits when the batch is full, or when the wait deadline passes
        with no dispatch in flight. While dispatches are running there
        is nothing idle to hand the batch to, so coalescing simply
        continues — this is what keeps batches full at moderate load.
        """
        first = q.get()
        if first is None:
            return []
        sp = detached("serve.collect")
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        graced = False
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                with self._stats_lock:
                    busy = self._inflight >= 1
                if busy:
                    # Extend while dispatches run; re-arm the grace so
                    # the window after THIS busy period also applies.
                    graced = False
                elif graced:
                    break
                else:
                    # One grace window right after a busy period: the
                    # finished batch's clients resubmit within ~1 ms,
                    # and scooping them here is what fills this batch
                    # (without it the loop locks into half-size batches
                    # alternating with the dispatch — measured avg 33/64).
                    graced = True
                deadline = time.perf_counter() + self.max_wait_s
                continue
            try:
                req = q.get(timeout=remaining)
            except queue.Empty:
                continue                         # re-check busy/deadline
            if req is None:
                q.put(None)  # stop after this batch drains
                break
            batch.append(req)
        if sp:
            sp.attrs.update(batch=bid, n=len(batch))
        sp.finish()
        return batch

    def _collector_loop(self, q, batches) -> None:
        while self._running:
            bid = next(self._batch_ids)
            batch = self._collect(q, bid)
            if not batch:
                break
            handoff = detached("serve.handoff")
            if handoff:
                handoff.attrs["batch"] = bid
            with self._stats_lock:
                self._inflight += 1
            # Blocks when `workers` batches are already in flight —
            # backpressure keeps coalescing ahead of dispatch.
            batches.put((bid, handoff, batch))
        # Drain: anything still queued after stop() must fail fast, not
        # leave callers hanging in future.result(timeout).
        while True:
            try:
                req = q.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.future.cancel()
        for _ in range(self.workers):
            batches.put(None)

    def _dispatch_loop(self, batches) -> None:
        while True:
            item = batches.get()
            if item is None:
                break
            bid, handoff, batch = item
            handoff.finish()
            t0 = time.perf_counter()
            waits = [(t0 - r.enqueued_at) * 1e3 for r in batch]
            with span("serve.dispatch") as sp:
                try:
                    # k and the batch are bucketed to powers of two as in
                    # the JAX package, so both search the same shapes.
                    k_eff = min(self._bucket(max(r.k for r in batch)),
                                self.max_k)
                    texts = [r.query for r in batch]
                    bucket = self._bucket(len(texts))
                    if sp:
                        sp.attrs.update(batch=bid, n=len(batch),
                                        bucket=bucket, k_eff=k_eff,
                                        wait_ms_sum=sum(waits),
                                        wait_ms_max=max(waits))
                    texts += [texts[-1]] * (bucket - len(texts))
                    q = self.embed_fn(texts)
                    res = self.index.search(np.atleast_2d(q), k=k_eff)
                    scores, ids = (res.scores, res.ids) \
                        if hasattr(res, "scores") else res
                    with span("serve.settle"):
                        for row, req in enumerate(batch):
                            # A caller may have cancelled (e.g. its own
                            # timeout) — including between a cancelled()
                            # check and set_result. Settle each future
                            # independently so one racing cancel can never
                            # poison the rest of the batch.
                            try:
                                req.future.set_result(
                                    (scores[row, : req.k],
                                     ids[row, : req.k]))
                            except InvalidStateError:
                                pass
                except Exception as exc:
                    for req in batch:
                        if not req.future.done():
                            req.future.set_exception(exc)
            with self._stats_lock:
                self._inflight -= 1
                self.stats["batches"] += 1
                self.stats["queries"] += len(batch)
                self.stats["max_batch_seen"] = max(
                    self.stats["max_batch_seen"], len(batch))
                self.stats["wait_ms_sum"] += sum(waits)

    def get_stats(self) -> dict:
        with self._stats_lock:
            s = dict(self.stats)
        s["avg_batch"] = (s["queries"] / s["batches"]) if s["batches"] else 0
        s["avg_queue_wait_ms"] = (s["wait_ms_sum"] / s["queries"]
                                  if s["queries"] else 0.0)
        return s
