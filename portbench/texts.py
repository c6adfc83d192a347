"""The frozen qa_docs texts: chunks and sentences.

``portbench/reference/qa_docs/`` is a copy of
``optimized_rag_tpu_torch/eval/qa_docs/`` at commit 6ca9d44. ``chunks``
and ``sentences`` copy ``qa_chunks`` and the sentence split of
``make_queries`` (``chip_smoke.py:417-435``).
"""

from __future__ import annotations

import glob
import os
import re

QA_DOCS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "reference", "qa_docs")


def chunks() -> list[str]:
    out = []
    for path in sorted(glob.glob(os.path.join(QA_DOCS, "*.md"))):
        with open(path, encoding="utf-8") as f:
            out += [p.strip() for p in f.read().split("\n\n") if p.strip()]
    if not out:
        raise FileNotFoundError(f"no qa_docs chunks under {QA_DOCS}")
    return out


def sentences() -> list[str]:
    return [s.strip() for c in chunks()
            for s in re.split(r"(?<=[.?!])\s+|\n+", c) if len(s.split()) > 3]
