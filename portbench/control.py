"""The control: the plain reference put in the program's place, one step
below the precision the configuration states, judged by the same check.

    python3 portbench/control.py --workload <name> --seeds 1 2 3

For text traffic the control's query vectors come from the plain encoder
with every matmul's inputs rounded to fp8 (e4m3; the configuration states
bfloat16), and its top-k scores float32 rows in TF32 (the configuration
states float32 with TF32 off). For vector traffic over bfloat16 rows its
rows are int8 codes with a float32 scale a row. It answers the texts or
query vectors a run of the cell would send first, at the cell's sizes,
and prints the numbers the check compares, one JSON line a seed. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT

from portbench import check, harness, system  # noqa: E402
from portbench.reference.topk import RunningTopK, store  # noqa: E402


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def control_topk(q: torch.Tensor, corpus, storage: str, k: int,
                 use_tf32: bool):
    """Top-k of float32 ``q`` over the corpus rows, stored as ``storage``
    and scored in float32 (TF32 where ``use_tf32``: the card's own on
    CUDA, inputs rounded to it elsewhere)."""
    emulate = use_tf32 and q.device.type != "cuda"
    top = RunningTopK(tf32(q) if emulate else q, k, dtype=torch.float32)
    for first, rows in corpus.blocks():
        r = store(rows, storage).float()
        top.feed(tf32(r) if emulate else r, first)
    return top.scores.cpu().numpy(), top.ids.cpu().numpy()


def control_answers(c, seed: int, device, n_answers: int):
    dev = torch.device(device)
    corpus = system.make_corpus(c.cfg, seed, dev)
    gen = importlib.import_module(f"portbench.traffic.{c.mix['generator']}")
    if c.mix["generator"] == "served":
        stream = gen.TextStream(c.mix, seed, 10, set())
        texts = [next(stream) for _ in range(n_answers)]
        model, tok = system.reference_encoder(c.cfg, dev,
                                              torch.float8_e4m3fn)
        q = model.encode(tok, texts, int(c.cfg["encoder"]["max_len"]))
        storage, use_tf32 = c.cfg["index"]["dtype"], True
    else:
        texts = None
        q = torch.cat([corpus.queries(int(c.mix["batch"]), label=i)
                       for i in range(int(c.mix["pool"]))])
        storage, use_tf32 = "int8", False
    k = int(c.mix["k"])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = use_tf32
    scores, ids = control_topk(q, corpus, storage, k, use_tf32)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ans = check.Answers.build(queries=q.cpu(), texts=texts, k=k,
                              scores=[scores], ids=[ids], missing=0)
    return corpus, ans


def run(c, seed: int, device, n_answers: int) -> dict:
    corpus, ans = control_answers(c, seed, device, n_answers)
    encoder = (system.reference_encoder(c.cfg, torch.device(device))
               if c.cfg.get("encoder") else None)
    numbers = check.compare(c.cfg, corpus, ans, seed, device, encoder)
    return {"workload": c.name, "seed": seed, "numbers": numbers,
            "correct": check.verdict(numbers, c.limits)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--answers", type=int, default=16384)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    c = harness.cell(harness.benchmark(), a.workload)
    for seed in a.seeds:
        print(json.dumps(run(c, seed, a.device, a.answers)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
