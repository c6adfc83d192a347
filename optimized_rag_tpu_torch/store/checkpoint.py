"""Training-state checkpointing: a trainer's params, optimizer state and
step counters, saved atomically so training can resume.

Held against ``optimized_rag_tpu/store/checkpoint.py`` (:28-84). The
directory layout is the JAX package's (``step_%08d`` under the checkpoint
directory; ``latest_step`` the largest), the format the port's own: one
``torch.save`` file, ``state.pt``, in each step's directory, read back with
``weights_only=True`` (nested dicts and lists of tensors, numbers and
strings). The JAX package writes orbax trees of optax namedtuples, which
the port cannot read; a training state does not cross packages (the model
checkpoints of ``models/pretrain.save_pretrained`` do).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch


def _to_cpu(state):
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_cpu(v) for v in state)
    return state


def _like(state, like):
    """``state``'s tensors on the devices (and in the dtypes) of ``like``'s
    tensors at the same place."""
    if isinstance(like, torch.Tensor) and isinstance(state, torch.Tensor):
        return state.to(like.device, like.dtype)
    if isinstance(like, dict) and isinstance(state, dict):
        return {k: _like(v, like[k]) if k in like else v
                for k, v in state.items()}
    if isinstance(like, (list, tuple)) and isinstance(state, (list, tuple)):
        return type(state)(_like(v, lk) for v, lk in zip(state, like))
    return state


class TrainCheckpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, state: Dict[str, Any]) -> str:
        """state: nested dict, e.g. {"params": trainer.params,
        "opt_state": trainer.opt_state, "step": n}. The step's directory
        appears whole or not at all."""
        path = self._path(step)
        tmp = tempfile.mkdtemp(prefix=".step_", dir=self.directory)
        try:
            torch.save(_to_cpu(state), os.path.join(tmp, "state.pt"))
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.replace(tmp, path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return path

    def restore(self, step: Optional[int] = None,
                like: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Restore the given (or latest) step, on the CPU, or where
        ``like``'s tensors are."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        state = torch.load(os.path.join(self._path(step), "state.pt"),
                           map_location="cpu", weights_only=True)
        return state if like is None else _like(state, like)

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                steps.append(int(name[5:13]))
        return max(steps) if steps else None
