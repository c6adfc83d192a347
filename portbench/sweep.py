"""Finds the knee of the open-loop ``/search`` cell: the highest offered
rate whose 95th percentile meets the limit with no growing backlog.

    python3 portbench/sweep.py --config minilm-l6.f32-4m \
        --traffic search-rate --seed 1 --seconds 8 --rates 400 800 1200

The limit is 4 x the median time of one full B=64 ``encode`` plus
``search`` (fresh texts, k as the mix asks), rounded up to 10 ms. Each
rate runs the mix's open loop in the same process, on its own texts, for
``--seconds`` after the mix's warm-up. A rate meets the limit when its
p95 does, and has no growing backlog when the window's answers reach 97%
of its arrivals and the last quarter's median latency is under twice the
first quarter's. Prints one JSON line a rate, then the limit, the knee and
0.8 x the knee; the mix's file takes the last three by hand.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT

import torch  # noqa: E402

from portbench import harness, readers, spans as spans_mod  # noqa: E402
from portbench import system as system_mod  # noqa: E402
from portbench.traffic import served  # noqa: E402


def full_batch_ms(sysm, mix, seed, reps=20) -> float:
    """Median ms of encode(64 fresh texts) then search(k_eff)."""
    server, svc, index = sysm.server, sysm.svc, sysm.index
    stream = served.TextStream(mix, seed, 14, set())
    k_eff = min(server._bucket(int(mix["k"])), server.max_k)
    times = []
    for _ in range(reps + 2):
        texts = [next(stream) for _ in range(server.max_batch)]
        t0 = time.perf_counter()
        index.search(svc.encode(texts), k_eff)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[2:])


def one_rate(sysm, mix, seed, seconds, rate, limit_ms) -> dict:
    d = served.Load(sysm, dict(mix, rate_qps=rate), seed)
    d.run(seconds)
    win = d.window()
    done = [r for r in win if r.error is None and r.ids is not None]
    lat = [(r.t_done - r.t_due) * 1e3 for r in done]
    q = max(1, len(lat) // 4)
    first, last = statistics.median(lat[:q]), statistics.median(lat[-q:])
    p95 = readers.percentile(lat + [math.inf] * (len(win) - len(done)), 95)
    steady = len(done) >= 0.97 * len(win) and last < 2 * first
    return {"rate_qps": rate, "sent": len(win), "answered": len(done),
            "p50_ms": readers.percentile(lat, 50), "p95_ms": p95,
            "p99_ms": readers.percentile(lat, 99),
            "first_quarter_p50_ms": first, "last_quarter_p50_ms": last,
            "lateness_ms": d.lateness_ms(),
            "meets": p95 <= limit_ms and steady}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    a = p.parse_args(argv)
    entry = next(c for c in harness.benchmark()["configs"]
                 if c["name"] == a.config)
    c = SimpleNamespace(cfg=harness.load_json(harness.ROOT, entry["file"]),
                        mix=harness.load_json(harness.HERE, "traffic",
                                              a.traffic + ".json"))
    torch.backends.cuda.matmul.allow_tf32 = False
    sysm = system_mod.System(c.cfg, a.seed, "cuda", spans_mod.Spans())
    served.Load(sysm, c.mix, a.seed).warm_shapes()
    batch_ms = full_batch_ms(sysm, c.mix, a.seed)
    limit = 10 * math.ceil(4 * batch_ms / 10)
    print(json.dumps({"full_batch_ms": batch_ms, "limit_ms": limit}),
          flush=True)
    knee = None
    for i, rate in enumerate(sorted(a.rates)):
        row = one_rate(sysm, c.mix, a.seed + 1 + i, a.seconds, rate, limit)
        print(json.dumps(row), flush=True)
        if row["meets"]:
            knee = rate
    print(json.dumps({"limit_ms": limit, "knee_qps": knee,
                      "rate_qps": None if knee is None else 0.8 * knee,
                      "device": torch.cuda.get_device_name()}), flush=True)
    sysm.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
