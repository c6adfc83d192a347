"""Generator: a language model serving RAG answers through the program's
``models/decoder.Generator`` (prefill into the model's own cache, then
cached greedy decode), judged by its logits against the plain float32
reference (``reference/deepseek_v2.py``).

The weights are drawn on the device: each tensor from a generator seeded
by (seed, tensor name), N(0, ``initializer_range``) in float32 rounded to
bfloat16, norm weights 1. ``System`` hands them to ``Generator`` as
``params``, the form a checkpoint takes; the check draws each layer's
again after the program has closed.

``compare`` reruns the reference over each kept row's prompt and the tokens
the program emitted, and holds the logits that the timed calls picked from
(the prefill's last position and every decode step) against its logits at
the same positions:

* ``missing``: rows of the window's calls with no answer (a failed call's
  rows; limit 0);
* ``score_err``: the largest relative L2 error of a logit row,
  ``|l - l_ref| / |l_ref|``;
* ``logit_err_med``: the median of the same over every compared row;
* ``rank_gap``: the largest amount by which the reference's best logit of
  a row lies above its logit of the token the program picked from that
  row (greedy decoding picks the program's largest).

The control is the reference with every matmul's inputs rounded to fp8
(e4m3) in the program's place, as many logit rows as a call keeps for the
first call's first and last prompts (``control_answers``).
"""

from __future__ import annotations

import hashlib
import statistics
import time
from types import SimpleNamespace

import torch

from portbench.reference.deepseek_v2 import Reference, param_shapes


def stream_seed(seed: int, name: str) -> int:
    digest = hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") & ((1 << 63) - 1)


def draw(cfg: dict, name: str, shape, seed: int, device) -> torch.Tensor:
    """One tensor of the model, bfloat16, on ``device``."""
    dev = torch.device(device)
    if name.endswith("norm.weight"):
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(stream_seed(seed, name))
    x = torch.randn(shape, generator=g, device=dev)
    return x.mul_(float(cfg["initializer_range"])).to(torch.bfloat16)


def weight_fn(cfg: dict, seed: int, device):
    shapes = param_shapes(cfg)
    return lambda name: draw(cfg, name, shapes[name], seed, device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class System:
    def __init__(self, cfg: dict, seed: int, device, spans):
        # A program without the model fails here, before any work.
        from optimized_rag_tpu_torch.models.deepseek_v2 import \
            DeepseekV2Config
        from optimized_rag_tpu_torch.models.decoder import Generator
        self.cfg = cfg
        self.spans = spans
        self.device = torch.device(device)
        self.phases = {}
        g = cfg["generator"]
        t = time.perf_counter()
        params = {name: draw(cfg, name, shape, seed, self.device)
                  for name, shape in param_shapes(cfg).items()}
        _sync(self.device)
        self.phases["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        self.generator = Generator(
            DeepseekV2Config.from_config(cfg), params=params,
            max_prompt_len=int(g["max_prompt_len"]),
            max_new_tokens=int(g["max_new_tokens"]), device=self.device,
            prefill_chunk=g.get("prefill_chunk"))
        del params
        self.phases["load"] = time.perf_counter() - t

    def generate(self, ids, pad_len, max_new: int, keep=None):
        """One call of the program; its prefill and decode spans, where
        the program recorded them, become host spans of those layers."""
        t0 = time.perf_counter()
        out = self.generator.generate_ids(ids, pad_len,
                                          max_new_tokens=max_new,
                                          keep_logits=keep)
        for r in phase_records(t0):
            self.spans.add(r.name.split(".")[1],
                           (r.start_ns / 1e9, r.end_ns / 1e9))
        return out

    def close(self) -> None:
        self.generator = None
        _sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def phase_records(t0: float) -> list:
    """The program's ``generate.prefill`` and ``generate.decode`` spans
    that start at or after ``t0``."""
    from optimized_rag_tpu_torch.utils import profiling
    recorder = getattr(profiling, "RECORDER", None)
    if recorder is None:
        return []
    return [r for r in recorder.records(t0)
            if r.name in ("generate.prefill", "generate.decode")]


def _rows(answers):
    """(ids, positions, program logits [n, V]) of every compared row."""
    for call in answers.calls:
        for prompt, toks, logits in zip(call["prompts"], call["tokens"],
                                        call["logits"]):
            n = logits.shape[0]
            seq = torch.cat([prompt, toks[:n - 1]])
            yield seq, torch.arange(len(prompt) - 1, len(prompt) - 1 + n), \
                logits


def compare(cfg: dict, system, answers, seed: int, device) -> dict:
    dev = torch.device(device)
    out = {"missing": answers.missing}
    rows = list(_rows(answers))
    if not rows:
        out["missing"] = max(out["missing"], 1)
        return out
    ref = Reference(cfg, weight_fn(cfg, seed, dev), dev)
    want = ref.logits([s for s, _, _ in rows], [p for _, p, _ in rows])
    errs, gaps = [], []
    for (_, _, got), w in zip(rows, want):
        got, w = got.to(dev).double(), w.double()
        errs += ((got - w).norm(dim=-1) / w.norm(dim=-1)).tolist()
        pick = got.argmax(dim=-1, keepdim=True)
        gaps += (w.max(dim=-1).values - w.gather(1, pick)[:, 0]).tolist()
    out.update(score_err=max(errs), logit_err_med=statistics.median(errs),
               rank_gap=max(gaps))
    return out


def control_answers(c, seed: int, device, n_answers: int):
    """The fp8 reference's logit rows for the first call's first and last
    prompts: at the prompt's last position and along a continuation of
    ``min(n_answers, new_tokens) - 1`` ids drawn from the seed, all from one
    forward (a row is judged alone, so the control need not pick its own
    tokens one forward at a time)."""
    from portbench.traffic.generate import kept_rows, make_pool
    dev = torch.device(device)
    pool, pad = make_pool(c.cfg, c.mix, seed, dev)
    prompts = [pool[0, r, int(pad[0, r]):].cpu() for r in kept_rows(c.mix)]
    n = max(1, min(n_answers, int(c.mix["new_tokens"])))
    g = torch.Generator().manual_seed(stream_seed(seed, "control"))
    toks = [torch.randint(0, int(c.mix["max_id"]) + 1, (n,), generator=g)
            for _ in prompts]
    ref = Reference(c.cfg, weight_fn(c.cfg, seed, dev), dev,
                    torch.float8_e4m3fn)
    logits = ref.logits([torch.cat([p, t[:n - 1]])
                         for p, t in zip(prompts, toks)],
                        [torch.arange(len(p) - 1, len(p) - 1 + n)
                         for p in prompts])
    call = {"prompts": prompts, "tokens": toks,
            "logits": [x.cpu() for x in logits]}
    return None, SimpleNamespace(calls=[call], missing=0)


def window_calls(run) -> list:
    """(``generate``, ``generate.prefill``, ``generate.decode``) records of
    each call that starts in the window, where the program recorded all
    three (a ``--trace 1`` run)."""
    from portbench import program_spans
    out = []
    for top, kids in program_spans.calls(run, "generate"):
        by = {k.name: k for k in kids}
        if "generate.prefill" in by and "generate.decode" in by:
            out.append((top, by["generate.prefill"], by["generate.decode"]))
    return out
