"""Compilation cache, held against ``optimized_rag_tpu/utils/compile_cache.py``.

The JAX package points JAX's persistent compilation cache at a user-level
directory so a fresh process skips the XLA compiles of its programs. The
port has no XLA programs to cache: its models run eagerly in PyTorch, and
its compiled code is the CUDA kernels and the C++ analyzer, which are built
once per source and flags into ``build/torch_kernels/`` and
``build/native/`` (``ops/_build.py``, ``native.py``) and reused from there.
"""

from __future__ import annotations


def setup_compilation_cache(settings) -> bool:
    """Kept for the reference's callers (the agent calls it at startup).
    Returns False: there is no XLA cache to enable, and the kernels' build
    cache needs no setup."""
    return False
