"""Device / runtime health checks.

Held against ``optimized_rag_tpu/utils/health.py``: the probe is a torch
matmul on ``device`` (the card unless the caller asks for the CPU), under a
timeout, since a wedged device hangs the first operation rather than
erroring. Used for serving readiness probes.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Dict


def check_device_health(timeout_s: float = 60.0, matmul_dim: int = 256,
                        device="cuda") -> Dict:
    """Run a tiny computation on ``device`` under a timeout.

    Returns {healthy, backend, device_count, latency_s} or
    {healthy: False, error}. Without a card the default device reports
    unhealthy; a CPU probe is healthy only when the caller asked for
    ``device="cpu"``.
    """
    def probe():
        import torch

        from optimized_rag_tpu_torch.device import resolve_device
        dev = resolve_device(device)
        t0 = time.perf_counter()
        x = torch.ones((matmul_dim, matmul_dim), dtype=torch.float32,
                       device=dev)
        y = float((x @ x).sum().item())
        if y != matmul_dim ** 3:
            raise ArithmeticError(f"probe matmul gave {y}, not "
                                  f"{matmul_dim ** 3}")
        return {
            "healthy": True,
            "backend": dev.type,
            "device_count": (torch.cuda.device_count()
                             if dev.type == "cuda" else 1),
            "latency_s": round(time.perf_counter() - t0, 3),
        }

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(probe).result(timeout=timeout_s)
    except concurrent.futures.TimeoutError:
        return {"healthy": False,
                "error": f"device did not respond within {timeout_s}s "
                         "(wedged or claimed by another process)"}
    except Exception as exc:
        return {"healthy": False, "error": f"{type(exc).__name__}: {exc}"}
    finally:
        pool.shutdown(wait=False)
