"""Checkpoint discovery for the agent, held against
``optimized_rag_tpu/models/pretrain.py`` (:330-383 ``load_pretrained``,
:385-398 ``find_checkpoint_dir``, :412-424 ``load_tokenizer``).

The agent starts by looking for trained encoders: ``<data_dir>/models``
first, then the repo's bundled ``checkpoints/pretrained``. A checkpoint is
``<name>.config.json`` plus ``<name>.params.npz`` in the JAX package's
layout; ``load_pretrained`` returns the port's ``TransformerConfig`` and a
torch state dict converted in memory (``models/convert.py``).

Only these three functions are ported so far. Pretraining (the trainers,
``default_corpus``, ``pretrain_all``, ``save_pretrained``) and the decoder
and grounded checkpoint families wait for ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from optimized_rag_tpu_torch.models import convert
from optimized_rag_tpu_torch.models.encoder import TransformerConfig


def load_pretrained(path: str, name: str
                    ) -> Optional[tuple[TransformerConfig, dict]]:
    """Returns (cfg, state_dict) of an encoder checkpoint (the bi-encoder
    or the cross-encoder), or None when no checkpoint exists."""
    cfg_path = os.path.join(path, f"{name}.config.json")
    params_path = os.path.join(path, f"{name}.params.npz")
    if not (os.path.exists(cfg_path) and os.path.exists(params_path)):
        return None
    with open(cfg_path) as f:
        blob = json.load(f)
    if "out_dim" not in blob:
        raise NotImplementedError(
            f"{name}: decoder and grounded checkpoints are not ported yet "
            "(ROADMAP.md Queue 1 item 9)")
    cfg = convert.load_config(path, name)
    return cfg, convert.flax_to_torch(convert.load_params(path, name), cfg)


def find_checkpoint_dir(data_dir: str) -> Optional[str]:
    """Search order: user data dir, then the repo's bundled checkpoints."""
    candidates = [
        os.path.join(data_dir, "models"),
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            "checkpoints", "pretrained"),
    ]
    for c in candidates:
        if os.path.exists(os.path.join(c, "biencoder.params.npz")):
            return c
    return None


load_tokenizer = convert.load_tokenizer
