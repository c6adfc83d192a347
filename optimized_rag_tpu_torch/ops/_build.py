"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources in ``optimized_rag_tpu_torch/csrc/`` have a plain C interface
(no PyTorch headers), so each compiles in seconds. They are built at first
use, one ``nvcc`` process per source started together, then linked into one
shared library under ``build/torch_kernels/`` at the repository root. The
library's file name carries a hash of the sources and the flags, so a stale
build is never loaded; it is written under a temporary name and moved into
place with ``os.replace``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# What the last build did: seconds, the library path and ptxas's report of
# registers and shared memory per kernel ("" when the library was cached).
build_info: dict = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # qT, qh, corpus, dtype, size, out, flag, B, N, D, tile, groups, split,
    # stream
    "orag_packed_extract": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _P],
    # qT, qh, corpus, dtype, cs, size, out, flag, B, N, D, tile, groups,
    # split, stream
    "orag_packed_extract_scaled": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, _P],
    # q8, qs, corpus, cs, size, out, flag, B, N, D, tile, groups, stream
    "orag_packed_extract_int8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _P],
    # qT, corpus, dtype, size, tiles, U, val, col, B, N, D, tile, rounds,
    # stream
    "orag_extract": [_P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    # qT, corpus, dtype, cs, size, tiles, U, val, col, B, N, D, tile,
    # rounds, stream
    "orag_extract_scaled": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                            _I, _I, _P],
    # qwT, qs, corpus, cs, size, tiles, U, val, col, B, N, D, tile, rounds,
    # stream
    "orag_extract_int8": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                          _I, _P],
    # qT, corpus, dtype, size, pair_tile, block_n, P, val, col, N, D, tile,
    # rounds, stream
    "orag_extract_pairs": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                           _I, _P],
    # qT, corpus, dtype, cs, size, pair_tile, block_n, P, val, col, N, D,
    # tile, rounds, stream
    "orag_extract_pairs_scaled": [_P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                                  _I, _I, _I, _I, _P],
    # qwT, qs, corpus, cs, size, pair_tile, block_n, P, val, col, N, D,
    # tile, rounds, stream
    "orag_extract_pairs_int8": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I,
                                _I, _I, _I, _P],
    # qT, corpus, dtype, size, s, idx, B, N, D, tile, tile_k, stream
    "orag_tile_topk": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # qT, corpus, dtype, cs, size, s, idx, B, N, D, tile, tile_k, stream
    "orag_tile_topk_scaled": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _P],
    # qT, qh, corpus, dtype, out, B, N, D, tile, split, stream
    "orag_scan_floor": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    # qh, corpus, dtype, out, B, N, D, tile, split, stream
    "orag_scan_sums": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
}


def find_nvcc() -> str:
    """``nvcc`` from PyTorch's CUDA_HOME, then /usr/local/cuda, then PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    tried = []
    for home in (CUDA_HOME, "/usr/local/cuda"):
        if home:
            path = os.path.join(home, "bin", "nvcc")
            tried.append(path)
            if os.access(path, os.X_OK):
                return path
    path = shutil.which("nvcc")
    tried.append("nvcc on PATH")
    if path:
        return path
    raise RuntimeError("nvcc not found; tried: " + ", ".join(tried))


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _library_path(nvcc: str) -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join([nvcc, *ARCH_FLAGS, *COMPILE_FLAGS]).encode())
    return os.path.join(BUILD_DIR, f"libtopk_kernels-{h.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands together; return their outputs, raise on failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate(timeout=BUILD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed "
                               f"({p.returncode}):\n{out}")
    return outs


def _build(nvcc: str, target: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR)
    try:
        objs, cmds = [], []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            cmds.append([nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", src,
                         "-o", obj])
        logs = _run_all(cmds)
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return "".join(logs)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        nvcc = find_nvcc()
        target = _library_path(nvcc)
        log = "" if os.path.exists(target) else _build(nvcc, target)
        lib = ctypes.CDLL(target)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.orag_error_string.argtypes = [ctypes.c_int]
        lib.orag_error_string.restype = ctypes.c_char_p
        build_info.update(seconds=time.perf_counter() - t0, library=target,
                          nvcc=nvcc, ptxas=log)
        _lib = lib
        return lib
