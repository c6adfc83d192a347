"""RAG answer generation: back-to-back ``Generator`` calls of ``batch``
prompts each, ``new_tokens`` greedy tokens a call.

Parameters (the mix's file): ``batch``; ``min_len`` and ``max_len``, the
prompt lengths in tokens, BOS included (a log-uniform quantile ladder of
``batch`` lengths, the same for every seed, in an order drawn from the
seed for each batch); ``new_tokens``; ``pool`` (batches made in set-up and
cycled); ``warm_new_tokens`` (the warm-up call's); ``max_id`` (prompt ids
are uniform over [0, max_id]: no tokenizer is in the repository). Each
prompt is BOS and then its ids, LEFT-padded to the configuration's
``max_prompt_len``, made on the device from the seed. Set-up runs one call
on the pool's first batch with ``warm_new_tokens``: every batch holds the
same lengths. The window starts calls until ``seconds`` have passed and
ends when the last returns. Each call keeps the logits of its first and
last rows for the check.
"""

from __future__ import annotations

import time

import torch


def ladder(mix: dict) -> torch.Tensor:
    """The ``batch`` prompt lengths: quantiles (i + 1/2) / batch of the
    log-uniform distribution over [min_len, max_len]."""
    b, lo, hi = int(mix["batch"]), int(mix["min_len"]), int(mix["max_len"])
    q = (torch.arange(b, dtype=torch.float64) + 0.5) / b
    return torch.round(lo * (hi / lo) ** q).long()


def kept_rows(mix: dict) -> tuple[int, int]:
    return 0, int(mix["batch"]) - 1


def make_pool(cfg: dict, mix: dict, seed: int, device):
    """(ids [pool, B, P], pad counts [pool, B]) on ``device``."""
    from portbench.systems.generator import stream_seed
    dev = torch.device(device)
    b, p = int(mix["batch"]), int(cfg["generator"]["max_prompt_len"])
    lengths = ladder(mix).to(dev)
    pad_id, bos = int(cfg["eos_token_id"]), int(cfg["bos_token_id"])
    col = torch.arange(p, device=dev)
    ids, pads = [], []
    for i in range(int(mix["pool"])):
        g = torch.Generator(device=dev).manual_seed(
            stream_seed(seed, f"prompts/{i}"))
        lens = lengths[torch.randperm(b, generator=g, device=dev)]
        x = torch.randint(0, int(mix["max_id"]) + 1, (b, p), generator=g,
                          device=dev)
        pad = p - lens
        x = torch.where(col[None] < pad[:, None], pad_id, x)
        x[torch.arange(b, device=dev), pad] = bos
        ids.append(x)
        pads.append(pad)
    return torch.stack(ids), torch.stack(pads)


class Load:
    def __init__(self, system, mix: dict, seed: int):
        self.system = system
        self.mix = mix
        self.new_tokens = int(mix["new_tokens"])
        self.pool, self.pad = make_pool(system.cfg, mix, seed,
                                        system.device)
        self.keep = kept_rows(mix)
        self.calls: list[tuple] = []    # (pool index, t0, t1, Generation)
        self.failed = 0
        self.t0 = self.t1 = 0.0
        self.on_open = self.on_close = lambda: None

    def warm_shapes(self) -> None:
        self.system.generate(self.pool[0], self.pad[0],
                             int(self.mix["warm_new_tokens"]))

    def run(self, seconds: float) -> None:
        self.on_open()
        self.t0 = time.perf_counter()
        end = self.t0 + seconds
        i, now = 0, self.t0
        while now < end:
            p = i % self.pool.shape[0]
            try:
                out = self.system.generate(self.pool[p], self.pad[p],
                                           self.new_tokens, self.keep)
                t1 = time.perf_counter()
                self.calls.append((p, now, t1, out))
            except Exception:               # counted as failed
                t1 = time.perf_counter()
                self.failed += 1
            now = t1
            i += 1
        self.t1 = now
        self.on_close()

    @property
    def attempted(self) -> int:
        return (len(self.calls) + self.failed) * self.pool.shape[1]

    def answers(self):
        """Each call's kept rows: the prompt's real ids, the tokens
        emitted and the logits picked from (on the host)."""
        from types import SimpleNamespace
        calls = []
        for p, _, _, out in self.calls:
            calls.append({
                "prompts": [self.pool[p, r, int(self.pad[p, r]):].cpu()
                            for r in self.keep],
                "tokens": [out.tokens[:, r] for r in self.keep],
                "logits": [out.logits[:, j].cpu()
                           for j in range(len(self.keep))]})
        return SimpleNamespace(calls=calls,
                               missing=self.failed * self.pool.shape[1])
