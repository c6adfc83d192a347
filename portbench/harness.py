"""One run of one cell: set-up, warm-up, the measured window, the metrics,
the check, and the result line.

Everything that belongs to one configuration, one traffic mix or one metric
is found by name: ``configs/<config>.json`` (which names its kind of system,
``systems/<kind>.py``), ``traffic/<mix>.json`` (which names its generator,
``traffic/<generator>.py``), ``metrics/<metric>.py`` (``read(run)``,
returning a number or None) and ``limits/<cell>.json`` (the check's
limits).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level modules no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "optimized_rag_tpu")


class Refused(Exception):
    """A run that prints no result (exit 2)."""


def load_json(*parts):
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(bench: dict, name: str) -> SimpleNamespace:
    """The workload ``name`` with its configuration, mix and limits."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise Refused(f"no workload named {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = load_json(ROOT, cfg_entry["file"])
    if "system" not in cfg:
        raise Refused(f"{cfg_entry['file']} has no \"system\" key naming "
                      f"its kind of system (systems/<kind>.py)")
    return SimpleNamespace(
        name=name, chips=int(w["chips"]), cfg=cfg,
        mix=load_json(HERE, "traffic", w["traffic"] + ".json"),
        limits=load_json(HERE, "limits", name + ".json"))


def kind(cfg: dict):
    """The module of the configuration's kind of system (see
    ``systems/__init__.py``)."""
    return importlib.import_module(f"portbench.systems.{cfg['system']}")


class Run(SimpleNamespace):
    """What a metric reader is given. An attribute it lacks is the
    system's: a kind's readers may read what its system keeps, such as the
    size of its state."""

    def __getattr__(self, name):
        return getattr(vars(self).get("system"), name)


def metrics_for(bench: dict, name: str, section: str) -> list[dict]:
    return [m for m in bench[section]
            if name in m.get("workloads", [name])]


def reader(metric: str):
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(c: SimpleNamespace, seed: int, seconds: float, trace: bool,
             device, t_start: float, metrics: list[dict]) -> dict:
    """Builds the system, drives the window, reads ``metrics`` and checks
    the answers; returns the fields of the result line."""
    import torch

    from portbench import check, spans as spans_mod
    sys_kind = kind(c.cfg)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    spans = spans_mod.Spans()
    phases = {"imports": time.perf_counter() - t_start}
    sysm = sys_kind.System(c.cfg, seed, dev, spans)
    phases.update(sysm.phases)
    gen = importlib.import_module(f"portbench.traffic.{c.mix['generator']}")
    load = gen.Load(sysm, c.mix, seed)
    t = time.perf_counter()
    load.warm_shapes()
    phases["warm_shapes"] = time.perf_counter() - t
    tracer = None
    marks = {}

    def stats():
        server = getattr(sysm, "server", None)
        return server.get_stats() if server is not None else None

    def on_open():
        marks["t0"], marks["stats0"] = time.perf_counter(), stats()
        if tracer is not None:
            tracer.open_window(marks["t0"])

    def on_close():
        marks["t1"], marks["stats1"] = time.perf_counter(), stats()
        if tracer is not None:
            tracer.close_window()
    load.on_open, load.on_close = on_open, on_close
    if trace:
        from portbench.trace import Trace
        tracer = Trace()
        tracer.start()
    if cuda:
        torch.cuda.synchronize()
    # Objects made in set-up (the program's modules, the inputs) leave the
    # collector's generations: a full collection would otherwise scan them
    # all, inside the window, at a time that varies from run to run.
    gc.collect()
    gc.freeze()
    load.run(seconds)
    gc.unfreeze()
    summary = tracer.stop(spans) if tracer is not None else None
    setup_s = marks["t0"] - t_start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    run = Run(cell=c, load=load, spans=spans, system=sysm, trace=summary,
              t0=marks["t0"], t1=marks["t1"], marks=marks, setup_s=setup_s)
    values = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    answers = load.answers()
    attempted = load.attempted
    failed = answers.missing
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        device_info["busy_s"] = summary["busy_ns"] / 1e9
        device_info["window_s"] = summary["window_ns"] / 1e9
    sysm.close()
    numbers = sys_kind.compare(c.cfg, sysm, answers, seed, dev)
    out = {"correct": check.verdict(numbers, c.limits),
           "attempted": attempted, "failed": failed, "metrics": values,
           "device": device_info}
    if summary is not None:
        out["breakdown"] = {
            "device_ops": [[n, v / 1e9] for n, v in
                           summary["by_name_ns"].most_common(10)],
            "idle_gaps": [[n, v / 1e9] for n, v in
                          summary["idle_gaps_ns"].most_common(10)]}
    out["checks"] = {n: {"value": v, "limit": c.limits.get(n)}
                     for n, v in numbers.items()}
    out["_notes"] = {"setup_phases_s": phases,
                     "window": _window_notes(run),
                     "lateness_ms": getattr(load, "lateness_ms",
                                            lambda: {})()}
    return out


def _window_notes(run) -> dict:
    """Host-side figures of the window for the standard error: mean span
    ms by layer and the requests answered in each fifth of the window."""
    from portbench import readers, spans
    notes = {f"{layer}_ms": readers.mean_ms(run, layer)
             for layer in spans.layers(run.spans)}
    done = [r.t_done for r in getattr(run.load, "requests", [])
            if getattr(r, "error", None) is None
            and readers.in_window(run, r.t_done)]
    if done:
        w = readers.window_s(run) / 5
        notes["answers_by_fifth"] = [
            sum(1 for t in done if run.t0 + i * w <= t < run.t0 + (i + 1) * w)
            for i in range(5)]
    return notes


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        bench = benchmark()
        c = cell(bench, args.workload)
        import torch
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() < c.chips:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell needs {c.chips}")
        section = "per_layer" if args.trace else "end_to_end"
        out = run_cell(c, args.seed, args.seconds, bool(args.trace),
                       "cuda", t_start, metrics_for(bench, c.name, section))
    except (Refused, OSError, ImportError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    notes = out.pop("_notes")
    print(f"portbench: notes {json.dumps(notes)}", file=sys.stderr)
    print(f"portbench: correct {out['correct']}", file=sys.stderr)
    for n, v in out["checks"].items():
        print(f"check {n} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
