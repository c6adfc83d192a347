#!/usr/bin/env python3
"""Count the SASS instructions a score in the packing epilogue of the
tensor-core scan (csrc/scan_mma.cuh), for one or more copies of the
package.

    python3 benchmarks_torch/sass_epilogue.py DIR [DIR ...] [--out FILE]

Needs nvcc's ``cuobjdump`` (the card's machine). Each DIR holds an
``optimized_rag_tpu_torch`` package (the repository root, or an earlier
commit unpacked with ``git archive``); its kernels build into DIR's own
``build/``. For every instantiation of ``scan_mma_kernel`` the SASS is cut
into basic blocks (at labels and after branches), and each block with one
integer max for each of a thread's 32 accumulators (the unit maxima) is
taken as a chunk epilogue: its opcodes are counted and divided by 32,
which gives the instructions a score. A packing instantiation has one
such block a path (a kernel with a separate path for ragged chunks two);
the top-two inserts (64 maxima) and the folds at the tile's end (96) are
left out, and F and the raw sums have none. Prints one JSON line a DIR
(and with ``--out`` writes the lines to FILE, and the SASS of the i-th
DIR's instantiations to FILE.i.sass).
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys

_MAX = ("IMNMX", "VIMNMX")
_ACC = 32          # accumulators a thread (kAcc)
_ENDS = ("BRA", "EXIT", "RET", "BRX", "JMX", "JMP", "CALL")
_INSN = re.compile(
    r"^\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_LABEL = re.compile(r"^\s*\.L_\w+:")


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for home in (CUDA_HOME, "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", name), os.X_OK):
            return os.path.join(home, "bin", name)
    path = shutil.which(name)
    if not path:
        raise RuntimeError(f"{name} not found")
    return path


def _library(pkg_dir: str) -> str:
    """Build (or find) the kernels' library of the package in ``pkg_dir``."""
    out = subprocess.run([sys.executable, "-c", (
        "import sys; sys.path.insert(0, sys.argv[1]); "
        "from optimized_rag_tpu_torch.ops import _build; "
        "_build.load_library(); print(_build.build_info['library'])"),
        os.path.abspath(pkg_dir)], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[-1]


def _functions(sass: str) -> dict[str, list[str]]:
    """The SASS of each scan_mma_kernel instantiation, by mangled name."""
    funcs: dict[str, list[str]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"^\s*Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1) if "scan_mma_kernel" in m.group(1) else None
            if name:
                funcs[name] = []
        elif name:
            funcs[name].append(line)
    return funcs


def _blocks(lines: list[str]) -> list[list[str]]:
    """Opcodes by basic block."""
    blocks, cur = [], []
    for line in lines:
        if _LABEL.match(line):
            if cur:
                blocks.append(cur)
            cur = []
            continue
        m = _INSN.match(line)
        if not m:
            continue
        op = m.group(2)
        cur.append(op)
        if op.split(".")[0] in _ENDS:
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    return blocks


def epilogues(lines: list[str]) -> list[dict]:
    """Each chunk epilogue block: its opcode counts and instructions a
    score."""
    out = []
    for ops in _blocks(lines):
        base = collections.Counter(op.split(".")[0] for op in ops)
        scores = sum(base[m] for m in _MAX)
        if scores == _ACC:
            out.append({"scores": scores, "instructions": len(ops),
                        "per_score": round(len(ops) / scores, 3),
                        "opcodes": dict(base.most_common())})
    return out


def _demangle(names: list[str]) -> list[str]:
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.strip().splitlines()
    except (RuntimeError, subprocess.CalledProcessError):
        return names


def run(pkg_dir: str, sass_out: str | None) -> dict:
    lib = _library(pkg_dir)
    sass = subprocess.run([_tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    funcs = _functions(sass)
    names = sorted(funcs)
    result = {"dir": pkg_dir, "library": lib, "kernels": {}}
    for mangled, pretty in zip(names, _demangle(names)):
        result["kernels"][pretty] = {"sass_lines": len(funcs[mangled]),
                                     "epilogues": epilogues(funcs[mangled])}
    if sass_out:
        with open(sass_out, "w") as f:
            for mangled in names:
                f.write(f"Function : {mangled}\n")
                f.write("\n".join(funcs[mangled]) + "\n")
    return result


def main() -> None:
    args = sys.argv[1:]
    out = None
    if "--out" in args:
        i = args.index("--out")
        out = args[i + 1]
        del args[i:i + 2]
    if not args:
        raise SystemExit(__doc__)
    lines = []
    for i, d in enumerate(args):
        res = run(d, f"{out}.{i}.sass" if out else None)
        lines.append(json.dumps(res))
        print(lines[-1], flush=True)
    if out:
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
