"""Cost and resource accounting.

API mirror of utils/cost_tracker.py:16-307 (track_embedding / track_llm /
track_search, daily rollups, JSON persistence, global singleton), extended
with the quantity that matters on an accelerator: device seconds. The per-model
pricing table covers external LLM calls the agent may still make for
generation; on-device embedding/rerank forwards are tracked as device time
(their dollar column is what the reference *would have paid* OpenAI — the
"savings" metric of the DW-GRPO reports).

Held against ``optimized_rag_tpu/store/cost.py``, a copy whose
imports name the port's modules.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

# $ per 1M tokens (input, output) — reference utils/cost_tracker.py:20-33.
PRICING = {
    "gpt-4o-mini": (0.15, 0.60),
    "gpt-4o": (2.50, 10.00),
    "text-embedding-3-small": (0.02, 0.0),
    "text-embedding-3-large": (0.13, 0.0),
    "on-device": (0.0, 0.0),
}
_SEARCH_COST = 0.001  # per web search call


class CostTracker:
    def __init__(self, persist_path: Optional[str] = None):
        self.persist_path = persist_path
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = defaultdict(float)
        self.daily: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        self._load()

    def _day(self) -> str:
        return time.strftime("%Y-%m-%d")

    def _add(self, metric: str, value: float) -> None:
        with self._lock:
            self.totals[metric] += value
            self.daily[self._day()][metric] += value

    # -------------------------------------------------------------- tracking

    def track_embedding(self, num_tokens: int,
                        model: str = "on-device",
                        device_seconds: float = 0.0) -> float:
        cost = PRICING.get(model, (0, 0))[0] * num_tokens / 1e6
        self._add("embedding_tokens", num_tokens)
        self._add("embedding_cost", cost)
        self._add("device_seconds", device_seconds)
        # What the same tokens would cost via the reference's API path.
        self._add("api_cost_avoided",
                  PRICING["text-embedding-3-small"][0] * num_tokens / 1e6)
        return cost

    def track_llm(self, input_tokens: int, output_tokens: int,
                  model: str = "gpt-4o-mini") -> float:
        pin, pout = PRICING.get(model, PRICING["gpt-4o-mini"])
        cost = (pin * input_tokens + pout * output_tokens) / 1e6
        self._add("llm_input_tokens", input_tokens)
        self._add("llm_output_tokens", output_tokens)
        self._add("llm_cost", cost)
        return cost

    def track_search(self, num_calls: int = 1) -> float:
        cost = _SEARCH_COST * num_calls
        self._add("search_calls", num_calls)
        self._add("search_cost", cost)
        return cost

    def track_device_time(self, seconds: float, op: str = "query") -> None:
        self._add("device_seconds", seconds)
        self._add(f"device_seconds_{op}", seconds)

    # ------------------------------------------------------------- reporting

    def get_total_cost(self) -> float:
        return (self.totals["embedding_cost"] + self.totals["llm_cost"]
                + self.totals["search_cost"])

    def get_summary(self) -> Dict:
        return {
            "total_cost_usd": round(self.get_total_cost(), 6),
            "api_cost_avoided_usd": round(
                self.totals["api_cost_avoided"], 6),
            "device_seconds": round(self.totals["device_seconds"], 3),
            **{k: round(v, 6) for k, v in self.totals.items()},
        }

    def get_cost_savings_report(self) -> Dict:
        """What the on-device path saved vs the reference's API spend
        (reference database/dw_grpo_persistence.py:410)."""
        avoided = self.totals["api_cost_avoided"]
        spent = self.get_total_cost()
        return {
            "api_cost_avoided_usd": round(avoided, 6),
            "actual_cost_usd": round(spent, 6),
            "net_savings_usd": round(avoided - spent, 6),
            "device_seconds": round(self.totals["device_seconds"], 3),
            "embedding_tokens_on_device": self.totals["embedding_tokens"],
        }

    def get_daily_report(self, days: int = 30) -> Dict[str, Dict]:
        cutoff = time.time() - days * 86400
        out = {}
        for day, metrics in sorted(self.daily.items()):
            ts = time.mktime(time.strptime(day, "%Y-%m-%d"))
            if ts >= cutoff:
                out[day] = {k: round(v, 6) for k, v in metrics.items()}
        return out

    # ----------------------------------------------------------- persistence

    def _load(self) -> None:
        if self.persist_path and os.path.exists(self.persist_path):
            try:
                with open(self.persist_path) as f:
                    data = json.load(f)
                self.totals.update(data.get("totals", {}))
                for day, metrics in data.get("daily", {}).items():
                    self.daily[day].update(metrics)
            except (json.JSONDecodeError, OSError):
                pass  # corrupt ledger: start fresh (fail-open)

    def save(self) -> None:
        if not self.persist_path:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.persist_path)),
                    exist_ok=True)
        with self._lock, open(self.persist_path, "w") as f:
            json.dump({"totals": dict(self.totals),
                       "daily": {d: dict(m) for d, m in self.daily.items()}},
                      f, indent=1)


_GLOBAL: Optional[CostTracker] = None


def get_cost_tracker(persist_path: Optional[str] = None) -> CostTracker:
    """Global singleton (reference utils/cost_tracker.py:302)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = CostTracker(persist_path)
    return _GLOBAL
