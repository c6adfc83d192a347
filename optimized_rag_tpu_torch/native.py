"""ctypes bridge to the C++ lexical analyzer (``native/analyzer.cpp``).

Held against ``optimized_rag_tpu/native.py``: the same entry points, giving
the same ids as the Python analyzer of ``index/lexical.py`` and
``models/tokenizer.py``. The native path handles ASCII text only
(byte-wise tokenization); a non-ASCII text takes the Python path, which is
authoritative, so every function here returns None for it.

The library is built at first use with ``g++`` from ``native/analyzer.cpp``
into ``build/native/`` at the repository root, never into ``native/``, and
only that build is loaded. Its file name carries a hash of the source, the
compiler and the flags; it is compiled under a temporary name and moved into
place with ``os.replace``, under a file lock, so processes that start
together build it once. The flags are the Makefile's without
``-march=native``: the analyzer hashes and counts integers, so the flag
changes no result, and a library built for one host's CPU could reach
another machine inside ``build/``. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_REPO, "native", "analyzer.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "native")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tls = threading.local()

_I64, _CHARS = ctypes.c_int64, ctypes.c_char_p
_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "orag_tokenize": (_I64, [_CHARS, _I64, _I64, _I32P, _I64]),
    "orag_term_counts": (_I64, [_CHARS, _I64, _I64, _I32P, _I32P, _I64,
                                ctypes.POINTER(_I64)]),
    "orag_model_tokenize": (_I64, [_CHARS, _I64, _I64, _I64, _I64, _I32P,
                                   _I64]),
    "orag_vocab_build": (_I64, [_CHARS, _I64, _I64, _I64, _I64]),
    "orag_vocab_free": (None, [_I64]),
    "orag_vocab_tokenize": (_I64, [_I64, _CHARS, _I64, _I32P, _I64]),
}


def find_compiler() -> str:
    """``g++`` on PATH (``$CXX`` where set)."""
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found on PATH; the "
                           "native analyzer cannot be built")
    return path


def library_path(cxx: Optional[str] = None) -> str:
    """Where the build of the current source, compiler and flags lives."""
    cxx = cxx or find_compiler()
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join([cxx, *CXX_FLAGS]).encode())
    return os.path.join(BUILD_DIR, f"liborag_native-{h.hexdigest()[:16]}.so")


def _compile(cxx: str, target: str) -> None:
    """Build ``target`` unless another process already has; holds an
    exclusive lock on ``build/native/lock`` meanwhile."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(target):
                return
            fd, tmp = tempfile.mkstemp(prefix="build-", suffix=".so",
                                       dir=BUILD_DIR)
            os.close(fd)
            try:
                out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                                     capture_output=True, text=True,
                                     timeout=BUILD_TIMEOUT_S)
                if out.returncode != 0:
                    raise RuntimeError(
                        f"building the native analyzer failed "
                        f"({out.returncode}):\n{out.stdout}{out.stderr}")
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load_library() -> ctypes.CDLL:
    """The analyzer's shared library, built on first use."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = find_compiler()
        target = library_path(cxx)
        if not os.path.exists(target):
            _compile(cxx, target)
        lib = ctypes.CDLL(target)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return lib


def _buffers(cap: int):
    """Two int32 output arrays of at least ``cap`` entries and an int64,
    owned by the calling thread and reused by its next call (a call copies
    its results out before it returns)."""
    bufs = getattr(_tls, "bufs", None)
    if bufs is None or len(bufs[0]) < cap:
        n = max(cap, 4096)
        bufs = _tls.bufs = ((ctypes.c_int32 * n)(), (ctypes.c_int32 * n)(),
                            _I64(0))
    return bufs


def build() -> bool:
    """Build (if needed) and load the library; raises if the build fails."""
    load_library()
    return True


def available() -> bool:
    """True once the library is loaded; builds it at first call."""
    return load_library() is not None


def tokenize_hash(text: str, vocab_size: int) -> Optional[np.ndarray]:
    """Lexical tokenization -> term ids; None for non-ASCII text."""
    if not text.isascii():
        return None
    lib = load_library()
    raw = text.encode()
    cap = max(len(raw), 16)
    out, _, _ = _buffers(cap)
    n = lib.orag_tokenize(raw, len(raw), vocab_size, out, cap)
    return np.frombuffer(out, np.int32, n).copy()


def term_counts(text: str, vocab_size: int
                ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Per-document (term_ids, tfs, doc_len); None for non-ASCII text."""
    if not text.isascii():
        return None
    lib = load_library()
    raw = text.encode()
    cap = max(len(raw), 16)
    terms, tfs, dlen = _buffers(cap)
    n = lib.orag_term_counts(raw, len(raw), vocab_size, terms, tfs, cap,
                             ctypes.byref(dlen))
    return (np.frombuffer(terms, np.int32, n).copy(),
            np.frombuffer(tfs, np.int32, n).copy(), int(dlen.value))


def model_tokenize(text: str, vocab_size: int, num_special: int = 4,
                   split_len: int = 12) -> Optional[List[int]]:
    """``HashTokenizer.tokenize``; None for non-ASCII text."""
    if not text.isascii():
        return None
    lib = load_library()
    raw = text.encode()
    cap = max(len(raw) * 2, 16)
    out, _, _ = _buffers(cap)
    n = lib.orag_model_tokenize(raw, len(raw), vocab_size, num_special,
                                split_len, out, cap)
    return out[:n]


def vocab_build(words: List[str], vocab_size: int, num_special: int = 4,
                split_len: int = 12) -> Optional[int]:
    """A native learned-vocabulary tokenizer; returns a handle for
    ``vocab_tokenize`` (None if the analyzer refuses the sizes). Words get
    ids num_special + index (VocabTokenizer's mapping); non-ASCII words are
    looked up by their UTF-8 bytes, though such text still takes Python."""
    lib = load_library()
    blob = "\n".join(words).encode("utf-8")
    h = lib.orag_vocab_build(blob, len(blob), vocab_size, num_special,
                             split_len)
    return int(h) or None


def vocab_free(handle: int) -> None:
    load_library().orag_vocab_free(handle)


def vocab_tokenize(handle: int, text: str) -> Optional[List[int]]:
    """``VocabTokenizer.tokenize``; None for non-ASCII text or an unknown
    handle."""
    if not text.isascii():
        return None
    lib = load_library()
    raw = text.encode()
    cap = max(len(raw) * 2, 16)
    out, _, _ = _buffers(cap)
    n = lib.orag_vocab_tokenize(handle, raw, len(raw), out, cap)
    if n < 0:
        return None
    return out[:n]
