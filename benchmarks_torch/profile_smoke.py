#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s wall time goes: the whole smoke, with its main
thread's stack sampled every 50 ms.

    python3 benchmarks_torch/profile_smoke.py [--out PATH]   # one card

Runs ``chip_smoke.main`` (its watchdog moved to 1,150 s, so that a slow
run still ends with a profile) after one JSON line ``cpu_env``: the host's
core counts, torch's thread counts and the seconds of a small and a large
CPU matmul loop at 1, 2, 4 and 8 threads. Writes PATH (default
``build/smoke_profile.json``): the sample period ``dt``, ``incl`` (each
function's samples, counted once a sample however often it is on the
stack) and ``chain2``/``chain3``/``chain4`` (the samples of each chain of
the smoke's own frames, outermost first, to that depth, as
``function:line``). A count times ``dt`` is seconds of wall time. The
smoke's own output is unchanged.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402

DT = 0.05


def cpu_env() -> dict:
    info = {"cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads(),
            "interop_threads": torch.get_num_interop_threads()}
    base = torch.get_num_threads()
    a, w = torch.randn(64, 384), torch.randn(384, 1536)
    b = torch.randn(1024, 1024)
    for n in sorted({1, 2, 4, 8, base}):
        torch.set_num_threads(n)
        t0 = time.perf_counter()
        for _ in range(2000):
            (a @ w).relu_()
        info[f"small_mm_2000_t{n}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(20):
            b @ b
        info[f"big_mm_20_t{n}_s"] = time.perf_counter() - t0
    torch.set_num_threads(base)
    return info


def main(argv) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "smoke_profile.json"))
    args = ap.parse_args(argv)
    print(json.dumps({"cpu_env": cpu_env()}), flush=True)
    incl = collections.Counter()
    chains = {d: collections.Counter() for d in (2, 3, 4)}
    done = threading.Event()

    def sample():
        main_id = threading.main_thread().ident
        while not done.wait(DT):
            frame = sys._current_frames().get(main_id)
            seen, chain = set(), []
            while frame is not None:
                code = frame.f_code
                name = code.co_filename
                if name.startswith(HERE):
                    name = os.path.relpath(name, HERE)
                else:
                    name = os.path.basename(name)
                key = f"{name}:{code.co_name}"
                if key not in seen:
                    incl[key] += 1
                    seen.add(key)
                if code.co_filename == S.__file__:
                    chain.append(f"{code.co_name}:{frame.f_lineno}")
                frame = frame.f_back
            chain.reverse()                 # outermost first, main() left out
            for d, counts in chains.items():
                counts[" > ".join(chain[1:1 + d])] += 1

    S.DEADLINE_S = 1150
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        S.main()
    finally:
        done.set()
        sampler.join()
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({"dt": DT, "incl": incl.most_common(400),
                       **{f"chain{d}": c.most_common(300)
                          for d, c in chains.items()}}, f, indent=0)


if __name__ == "__main__":
    main(sys.argv[1:])
