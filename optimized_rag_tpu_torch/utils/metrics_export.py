"""JSONL metrics export (reference rag/nodes/helpers.py:643-674:
metrics_logs/metrics_YYYY-MM-DD.jsonl).

Held against ``optimized_rag_tpu/utils/metrics_export.py``, a copy whose
imports name the port's modules.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsExporter:
    def __init__(self, directory: str = "metrics_logs"):
        self.directory = directory

    def export(self, record: Dict) -> str:
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(
            self.directory, f"metrics_{time.strftime('%Y-%m-%d')}.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps({"ts": time.time(), **record},
                               default=str) + "\n")
        return path
