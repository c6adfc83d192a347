"""``/search`` traffic through ``QueryServer.submit``, closed or open loop.

Parameters (the mix's file):

* ``loop``: ``"closed"`` (``clients`` callers, each with one request in
  flight, sending the next as soon as its answer comes) or ``"open"``
  (arrivals at ``rate_qps``, Poisson: the gaps are the quantiles of an
  exponential, in an order drawn from the seed, so every seed offers the
  same gaps);
* ``k``: results a request asks for;
* ``words``: the texts' lengths in words, ``median`` * exp(``sigma`` * z)
  at the quantiles z of a standard normal, cut to [``min``, ``max``]: the
  same lengths for every seed, in an order drawn from it;
* ``reword_share``: share of texts that start with a rewording prefix;
* ``warmup_s``: seconds of the same load before the window opens.

A text is a span of that many words out of the frozen qa_docs sentences,
run together; no text is sent twice in a run, so the encoder's cache never
answers. A request is timed from when it was due (open loop) or sent
(closed loop) to when its future is settled.
"""

from __future__ import annotations

import math
import random
import statistics
import threading
import time
from dataclasses import dataclass

import numpy as np

from portbench import texts as qa
from portbench.corpus.clustered import stream_seed

PREFIXES = ["tell me about", "what does the doc say on", "explain"]
_QUANTILES = 4096
# Texts made ahead per second of closed-loop load: twice the most any run
# has answered.
PREMADE_PER_S = 4096


@dataclass
class Request:
    text: str
    t_due: float
    t_sent: float = 0.0
    t_done: float = 0.0
    scores: np.ndarray | None = None
    ids: np.ndarray | None = None
    error: str | None = None
    in_window: bool = False


class TextStream:
    """Distinct query texts, drawn from ``seed`` and a stream label."""

    def __init__(self, mix: dict, seed: int, label: int, used: set):
        w = mix["words"]
        z = [statistics.NormalDist().inv_cdf((i + 0.5) / _QUANTILES)
             for i in range(_QUANTILES)]
        self.lengths = [min(w["max"], max(w["min"], round(
            w["median"] * math.exp(w["sigma"] * zi)))) for zi in z]
        self.rng = random.Random(stream_seed(seed, label))
        self.rng.shuffle(self.lengths)
        self.words = [x for s in qa.sentences() for x in s.split()]
        self.reword = float(mix["reword_share"])
        self.used = used
        self.n = 0

    def __next__(self) -> str:
        length = self.lengths[self.n % len(self.lengths)]
        self.n += 1
        while True:
            p = self.rng.randrange(len(self.words))
            span = [self.words[(p + i) % len(self.words)]
                    for i in range(length)]
            if self.rng.random() < self.reword:
                span = self.rng.choice(PREFIXES).split() + span[1:]
            text = " ".join(span)
            if text not in self.used:
                self.used.add(text)
                return text


def _gaps(rate: float, seed: int) -> list[float]:
    gaps = [-math.log(1.0 - (i + 0.5) / _QUANTILES) / rate
            for i in range(_QUANTILES)]
    random.Random(stream_seed(seed, 12)).shuffle(gaps)
    return gaps


class Load:
    """Drives ``system.server``; keeps every request of the run."""

    def __init__(self, system, mix: dict, seed: int):
        self.system = system
        self.mix = mix
        self.k = int(mix["k"])
        used: set = set()
        self.window_texts = TextStream(mix, seed, 10, used)
        self.warm_texts = TextStream(mix, seed, 11, used)
        self.seed = seed
        self.requests: list[Request] = []
        self.t0 = self.t1 = 0.0
        # Called as the window opens and closes (the harness's marks).
        self.on_open = self.on_close = lambda: None

    # -------------------------------------------------------------- warm-up

    def warm_shapes(self) -> None:
        """Every encoder bucket (batch 8/32/64 by sequence 8..128) and
        every padded batch the server can search with this k, outside the
        benchmark's spans."""
        sysm = self.system
        svc, index, server = sysm.svc, sysm.index, sysm.server
        n = 0
        top = svc._bucket_batch(server.max_batch)
        for b in [x for x in svc.BATCH_BUCKETS if x <= top]:
            for tokens in (6, 14, 30, 62, svc.max_len):
                batch = []
                for _ in range(b):
                    n += 1
                    batch.append(" ".join([f"warm{n}"] + ["x"] * (tokens - 3)))
                svc.encode(batch)
        k_eff = min(server._bucket(self.k), server.max_k)
        rng = np.random.default_rng(stream_seed(self.seed, 13))
        b = 1
        while b <= server.max_batch:
            q = rng.standard_normal((b, index.dim)).astype(np.float32)
            index.search(q, k_eff)
            b *= 2

    # ---------------------------------------------------------------- load

    def run(self, seconds: float) -> None:
        """Warm-up load for ``warmup_s``, then the window of ``seconds``;
        waits up to a minute past the close for every answer due. The
        texts are made before the load starts."""
        warm_s = float(self.mix["warmup_s"])
        if self.mix["loop"] == "closed":
            per_s = PREMADE_PER_S
            extra = int(self.mix["clients"])
        else:
            per_s = float(self.mix["rate_qps"]) * 1.05
            extra = 64
        self._texts = {False: [next(self.warm_texts) for _ in range(
            int(per_s * warm_s) + extra)],
            True: [next(self.window_texts) for _ in range(
                int(per_s * seconds) + extra)]}
        self._lock = threading.Lock()
        self._inflight = 0
        self._drained = threading.Event()
        server = self.system.server
        server.start()
        try:
            start = time.perf_counter() + 0.01
            self.t0 = start + warm_s
            self.t1 = self.t0 + seconds
            if self.mix["loop"] == "closed":
                self._closed(start)
            else:
                self._open(start)
            self._drained.wait(timeout=max(0.0, self.t1 + 60.0
                                           - time.perf_counter()))
        finally:
            server.stop()

    def _text(self, window: bool) -> str:
        """The next premade text (made on the spot should they run out)."""
        with self._lock:
            premade = self._texts[window]
            if premade:
                return premade.pop()
            return next(self.window_texts if window else self.warm_texts)

    def _send(self, t_due: float) -> None:
        window = t_due >= self.t0
        rec = Request(self._text(window), t_due=t_due, in_window=window)
        self.requests.append(rec)
        with self._lock:
            self._inflight += 1
        rec.t_sent = time.perf_counter()
        try:
            fut = self.system.server.submit(rec.text, k=self.k)
        except Exception as exc:            # counted as failed
            rec.error = repr(exc)
            self._settled(rec)
            return
        fut.add_done_callback(lambda f, rec=rec: self._settle(f, rec))

    def _settle(self, fut, rec: Request) -> None:
        try:
            rec.scores, rec.ids = fut.result()
        except Exception as exc:
            rec.error = repr(exc)
        self._settled(rec)

    def _settled(self, rec: Request) -> None:
        """Runs on the thread that settled the request: in the closed
        loop its client sends the next request from here, so no thread of
        the benchmark wakes between the answer and the next send."""
        rec.t_done = time.perf_counter()
        if self.mix["loop"] == "closed" and rec.t_done < self.t1:
            self._send(rec.t_done)
        with self._lock:
            self._inflight -= 1
            idle = self._inflight == 0
        if idle and rec.t_done >= self.t1:
            self._drained.set()

    def _sleep_until(self, t: float) -> None:
        wait = t - time.perf_counter()
        if wait > 0:
            time.sleep(wait)

    def _closed(self, start: float) -> None:
        self._sleep_until(start)
        for _ in range(int(self.mix["clients"])):
            self._send(time.perf_counter())
        self._sleep_until(self.t0)
        self.on_open()
        self._sleep_until(self.t1)
        self.on_close()
        with self._lock:
            if self._inflight == 0:
                self._drained.set()

    def _open(self, start: float) -> None:
        gaps = _gaps(float(self.mix["rate_qps"]), self.seed)
        due, i, opened = start, 0, False
        while due < self.t1:
            self._sleep_until(due)
            if due >= self.t0 and not opened:
                opened = True
                self.on_open()
            self._send(due)
            due += gaps[i % len(gaps)]
            i += 1
        self._sleep_until(self.t1)
        self.on_close()
        with self._lock:
            if self._inflight == 0:
                self._drained.set()

    # ------------------------------------------------------------ results

    def window(self) -> list[Request]:
        return [r for r in self.requests if r.in_window]

    def lateness_ms(self) -> dict:
        late = sorted((r.t_sent - r.t_due) * 1e3 for r in self.window())
        if not late:
            return {}
        return {"p50": late[len(late) // 2],
                "p99": late[min(len(late) - 1, int(0.99 * len(late)))],
                "max": late[-1]}

    def answers(self):
        """The window's requests as the check reads them: the program's
        query vectors come from the encode spans (the vectors it searched)."""
        from portbench.check import Answers
        reqs = self.window()
        emb = {}
        for _, _, texts, out in self.system.spans.encode:
            for t, v in zip(texts, out):
                emb[t] = v
        ok = [r for r in reqs if r.error is None and r.ids is not None
              and r.text in emb]
        return Answers.build(
            queries=np.stack([emb[r.text] for r in ok]) if ok else None,
            texts=[r.text for r in ok], k=self.k,
            scores=[r.scores for r in ok], ids=[r.ids for r in ok],
            missing=len(reqs) - len(ok))

    @property
    def attempted(self) -> int:
        return len(self.window())
