"""Exponential-backoff retry decorator (reference utils/retry_utils.py:21-59
uses tenacity; this is dependency-free with the same shape).

Held against ``optimized_rag_tpu/utils/retry.py``, a copy whose
imports name the port's modules.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Tuple, Type


def retry_with_backoff(max_attempts: int = 3, base_delay: float = 0.5,
                       max_delay: float = 10.0,
                       exceptions: Tuple[Type[BaseException], ...] =
                       (Exception,), sleep: Callable = time.sleep):
    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            delay = base_delay
            for attempt in range(1, max_attempts + 1):
                try:
                    return fn(*args, **kwargs)
                except exceptions:
                    if attempt == max_attempts:
                        raise
                    sleep(min(delay, max_delay))
                    delay *= 2
            raise RuntimeError("unreachable")
        return wrapper
    return decorator
