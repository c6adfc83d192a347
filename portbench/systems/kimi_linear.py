"""Kimi Linear: one expert-parallel rank's share of Kimi-Linear-48B-A3B
serving RAG answers through the program's ``models/decoder.Generator``
(prefill into the hybrid cache, then cached greedy decode), judged by its
logits against the plain float32 reference (``reference/kimi_linear.py``),
which holds the same share.

The weights are drawn on the device from generators seeded by (seed,
tensor name), as ``systems/generator.py`` draws them: N(0,
``initializer_range``) in float32 rounded to bfloat16, norm weights 1; and
in float32, where the model keeps them so, ``A_log = ln U(1, 16)``,
``dt_bias`` the inverse softplus of dt log-uniform on [0.001, 0.1], and
the router's ``e_score_correction_bias`` N(0, ``initializer_range``).

``compare`` and the control are ``systems/generator.py``'s (the same
numbers: ``missing``, ``score_err``, ``logit_err_med``, ``rank_gap``) with
this model's reference in place of DeepSeek-V2's, and with one change: the
reference routes each compared row as the program routed it. The program
keeps the router ids its kept rows picked at every slot
(``kimi_linear.RouteLog``), and the reference's MoE layers take those ids
and weigh them by its own scores. In bf16 a near-tie of the router goes
either way, and a pick flipped (a third of an expert's share after the
renormalisation to 2.446) carries through every later layer: over 26 MoE
layers the logits of a right program then differ by a fifth, a wrong one
by hardly more. Routed alike, the logits differ by the rounding. The
routing is judged on its own:

* ``route_gap``: the largest, over the compared rows' tokens and MoE
  layers, amount by which the reference's k-th best biased score lies
  above its biased score of the program's worst pick (0 where the program
  picked the reference's own top k; a near-tie the rounding decided reads
  about the rounding).

A program that keeps no routing, or leaves a compared slot unrouted,
reads no ``route_gap``, and so is not ``correct``.
"""

from __future__ import annotations

import math
import statistics
import time
from types import SimpleNamespace

import torch

from portbench.reference.kimi_linear import Reference, param_shapes
from portbench.systems.generator import (_rows, _sync, draw as draw_bf16,
                                         phase_records, stream_seed)

_FLOAT32 = ("A_log", "dt_bias", "e_score_correction_bias")


def draw(cfg: dict, name: str, shape, seed: int, device) -> torch.Tensor:
    """One tensor of the model on ``device``."""
    if not name.endswith(_FLOAT32):
        return draw_bf16(cfg, name, shape, seed, device)
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(stream_seed(seed, name))
    if name.endswith("A_log"):
        return torch.empty(shape, device=dev).uniform_(1, 16,
                                                       generator=g).log_()
    if name.endswith("dt_bias"):
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.rand(shape, generator=g, device=dev).mul_(hi - lo).add_(
            lo).exp_().clamp_min_(1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    return torch.randn(shape, generator=g, device=dev).mul_(
        float(cfg["initializer_range"]))


def weight_fn(cfg: dict, seed: int, device):
    shapes = param_shapes(cfg)
    return lambda name: draw(cfg, name, shapes[name], seed, device)


class System:
    def __init__(self, cfg: dict, seed: int, device, spans):
        # A program without the model fails here, before any work.
        from optimized_rag_tpu_torch.models.decoder import Generator
        from optimized_rag_tpu_torch.models.kimi_linear import \
            KimiLinearConfig
        self.cfg = cfg
        self.spans = spans
        self.device = torch.device(device)
        self.phases = {}
        self.routes = []
        g = cfg["generator"]
        t = time.perf_counter()
        params = {name: draw(cfg, name, shape, seed, self.device)
                  for name, shape in param_shapes(cfg).items()}
        _sync(self.device)
        self.phases["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        self.generator = Generator(
            KimiLinearConfig.from_config(cfg), params=params,
            max_prompt_len=int(g["max_prompt_len"]),
            max_new_tokens=int(g["max_new_tokens"]), device=self.device,
            prefill_chunk=g.get("prefill_chunk"))
        del params
        self.phases["load"] = time.perf_counter() - t

    def generate(self, ids, pad_len, max_new: int, keep=None):
        """One call of the program; its prefill and decode spans, where
        the program recorded them, become host spans of those layers. With
        ``keep``, the kept rows' routing, where the program kept it, goes
        to ``self.routes`` (a call's: the ids [MoE layers, rows, slots, k]
        and the prompts' width P)."""
        t0 = time.perf_counter()
        out = self.generator.generate_ids(ids, pad_len,
                                          max_new_tokens=max_new,
                                          keep_logits=keep)
        if keep is not None:
            log = getattr(out, "routes", None)
            self.routes.append(None if log is None
                               else (log.ids, ids.shape[1]))
        for r in phase_records(t0):
            self.spans.add(r.name.split(".")[1],
                           (r.start_ns / 1e9, r.end_ns / 1e9))
        return out

    def close(self) -> None:
        self.generator = None
        _sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def given_routes(system, answers):
    """The program's router ids [MoE layers, len, k] of each compared
    row's sequence (``_rows``' order), or None where it kept none for a
    call or left a slot unrouted."""
    calls = getattr(system, "routes", None) or []
    if len(calls) != len(answers.calls):
        return None
    out = []
    for kept, call in zip(calls, answers.calls):
        if kept is None:
            return None
        ids, p = kept
        for j, (prompt, logits) in enumerate(zip(call["prompts"],
                                                 call["logits"])):
            r = ids[:, j, p - len(prompt):p + logits.shape[0] - 1].cpu()
            if bool((r < 0).any()):
                return None
            out.append(r)
    return out


def compare(cfg: dict, system, answers, seed: int, device) -> dict:
    dev = torch.device(device)
    out = {"missing": answers.missing}
    rows = list(_rows(answers))
    if not rows:
        out["missing"] = max(out["missing"], 1)
        return out
    given = given_routes(system, answers)
    ref = Reference(cfg, weight_fn(cfg, seed, dev), dev)
    want = ref.logits([s for s, _, _ in rows], [p for _, p, _ in rows],
                      given)
    if given is not None:
        out["route_gap"] = max(float(g.max()) for g in ref.gaps)
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
    prompts, as ``systems/generator.py``'s control makes them, and its
    routing in the program's place."""
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
    # The fp8 reference's own routing, laid out as the program keeps its.
    p = max(len(x) for x in prompts)
    ids = torch.full((ref.routes[0].shape[0], len(prompts), p + n,
                      ref.routes[0].shape[-1]), -1, dtype=torch.int16)
    for j, (x, r) in enumerate(zip(prompts, ref.routes)):
        ids[:, j, p - len(x):p + n - 1] = r
    return (SimpleNamespace(routes=[(ids, p)]),
            SimpleNamespace(calls=[call], missing=0))
