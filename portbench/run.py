"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

See ``portbench/README.md``.
"""

import time

T_START = time.perf_counter()   # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The bytecode of every module the run imports, torch's and the program's
# with the harness's, is cached inside the checkout at a fixed path: an
# installation may hold no bytecode of its own, and then every run would
# compile some thousand of torch's sources on the host again. Only the
# first run of a checkout compiles them.
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
sys.dont_write_bytecode = False
# The repository root in place of this script's folder, whose module names
# (trace, check, ...) would shadow the standard library's.
sys.path[0] = ROOT
# Every kernel cache of the run stays inside the checkout, at fixed paths.
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build",
                                                       "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(
    ROOT, "build", "torch_extensions"))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
