"""Token budgeting (reference utils/context.py:33-254).

The reference counts tokens with tiktoken against OpenAI models; here the
default counter is the framework's own tokenizer (models/tokenizer.py) with
a chars/4 fast path, which is what budget decisions actually need.

Held against ``optimized_rag_tpu/utils/tokens.py``, a copy whose
imports name the port's modules.
"""

from __future__ import annotations

from typing import Dict, List, Optional

_DEFAULT_ALLOCATION = {
    "system": 0.10, "core_memory": 0.15, "conversation": 0.25,
    "rag_context": 0.40, "response": 0.10,
}


def calculate_tokens(text: str, tokenizer=None) -> int:
    if tokenizer is not None:
        return len(tokenizer.tokenize(text))
    return max(1, len(text) // 4)


def calculate_messages_tokens(messages: List[Dict], tokenizer=None) -> int:
    return sum(calculate_tokens(m.get("content", ""), tokenizer) + 4
               for m in messages)


def token_budget(max_context_tokens: int,
                 allocation: Optional[Dict[str, float]] = None
                 ) -> Dict[str, int]:
    alloc = allocation or _DEFAULT_ALLOCATION
    return {k: int(v * max_context_tokens) for k, v in alloc.items()}


def check_context_overflow(parts: Dict[str, str], max_context_tokens: int,
                           allocation: Optional[Dict[str, float]] = None,
                           tokenizer=None) -> Dict:
    budget = token_budget(max_context_tokens, allocation)
    usage = {k: calculate_tokens(v, tokenizer) for k, v in parts.items()}
    over = {k: usage[k] - budget.get(k, 0) for k in usage
            if usage[k] > budget.get(k, 0)}
    return {"total": sum(usage.values()), "usage": usage, "budget": budget,
            "overflow": over, "fits": not over
            and sum(usage.values()) <= max_context_tokens}


def truncate_conversation(messages: List[Dict], max_tokens: int,
                          tokenizer=None, keep_first: int = 1) -> List[Dict]:
    """Drop oldest messages (after the first ``keep_first`` system turns)
    until the budget fits (reference utils/context.py:truncate_conversation)."""
    head = messages[:keep_first]
    tail = list(messages[keep_first:])
    while tail and calculate_messages_tokens(head + tail,
                                             tokenizer) > max_tokens:
        tail.pop(0)
    return head + tail
