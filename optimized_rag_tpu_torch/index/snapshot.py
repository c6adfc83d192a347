"""Index snapshot/restore.

The reference's durability is the Postgres server (SURVEY.md §5
checkpoint/resume: "index shards + centroids + learned weights checkpointed
via orbax-style arrays"). Here every index exposes ``state_dict()`` /
``from_state_dict()`` and this module persists those as compressed .npz +
JSON metadata under a snapshot directory — cheap, dependency-free, and
byte-stable for tests.

Held against ``optimized_rag_tpu/index/snapshot.py``, a copy: the same
files and format stamp, so each package loads what the other saves (the
indexes' ``state_dict`` layouts are shared; bfloat16 and float16 rows are
saved as float32).
"""

from __future__ import annotations

import json
import os

import numpy as np


# Bump when the snapshot layout changes incompatibly; loaders for old
# versions go in _UPGRADERS. Version 0 = round-1 snapshots (no stamp).
SNAPSHOT_FORMAT_VERSION = 1
_UPGRADERS = {0: lambda state: state}  # v0 fields are v1-compatible


def save_state(path: str, name: str, state: dict) -> str:
    """Persist one component's state dict. Arrays -> .npz, scalars -> json.
    The JSON carries a format-version stamp so a later schema change can
    detect and upgrade (or refuse) old data dirs instead of silently
    corrupting them."""
    os.makedirs(path, exist_ok=True)
    arrays, meta = {}, {"__format_version__": SNAPSHOT_FORMAT_VERSION}
    for key, val in state.items():
        if isinstance(val, np.ndarray):
            arrays[key] = val
        else:
            meta[key] = val
    np.savez_compressed(os.path.join(path, f"{name}.npz"), **arrays)
    with open(os.path.join(path, f"{name}.json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)
    return path


def load_state(path: str, name: str) -> dict:
    with open(os.path.join(path, f"{name}.json")) as f:
        state = json.load(f)
    version = int(state.pop("__format_version__", 0))
    if version > SNAPSHOT_FORMAT_VERSION:
        raise ValueError(
            f"snapshot {name!r} has format v{version}, newer than this "
            f"build's v{SNAPSHOT_FORMAT_VERSION} — refusing to load")
    with np.load(os.path.join(path, f"{name}.npz"), allow_pickle=False) as z:
        for key in z.files:
            state[key] = z[key]
    for v in range(version, SNAPSHOT_FORMAT_VERSION):
        state = _UPGRADERS[v](state)
    return state


def exists(path: str, name: str) -> bool:
    return (os.path.exists(os.path.join(path, f"{name}.json"))
            and os.path.exists(os.path.join(path, f"{name}.npz")))
