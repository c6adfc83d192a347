"""Logging setup (reference utils/logging_config.py:11-53).

Held against ``optimized_rag_tpu/utils/logging_config.py``; it configures
the port's own logger namespace, ``optimized_rag_tpu_torch``."""

from __future__ import annotations

import logging
import sys
from typing import Optional


def setup_logging(level: str = "INFO", log_file: Optional[str] = None
                  ) -> logging.Logger:
    root = logging.getLogger("optimized_rag_tpu_torch")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    if not root.handlers:
        fmt = logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s")
        console = logging.StreamHandler(sys.stderr)
        console.setFormatter(fmt)
        root.addHandler(console)
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            root.addHandler(fh)
    return root
