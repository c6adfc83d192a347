"""Checkpoint discovery for the agent and the local generators, held
against ``optimized_rag_tpu/models/pretrain.py`` (:330-383
``load_pretrained``, :385-398 ``find_checkpoint_dir``, :412-424
``load_tokenizer``).

The agent starts by looking for trained encoders: ``<data_dir>/models``
first, then the repo's bundled ``checkpoints/pretrained``. A checkpoint is
``<name>.config.json`` plus ``<name>.params.npz`` in the JAX package's
layout; ``load_pretrained`` returns the port's configuration of its family
(``TransformerConfig`` for the encoders, ``GroundedConfig`` for the grounded
pointer-generator, ``DecoderConfig`` for the decoder LM) and a torch state
dict converted in memory (``models/convert.py``).

Only these three functions are ported so far. Pretraining (the trainers,
``default_corpus``, ``pretrain_all``, ``save_pretrained``) waits for the
training half of ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from optimized_rag_tpu_torch.models import convert


def load_pretrained(path: str, name: str) -> Optional[tuple]:
    """Returns (cfg, state_dict) of a checkpoint, or None when none
    exists. The family follows the config as in the reference: ``out_dim``
    marks an encoder, ``copy_dim`` the grounded generator, anything else
    the decoder LM."""
    cfg_path = os.path.join(path, f"{name}.config.json")
    params_path = os.path.join(path, f"{name}.params.npz")
    if not (os.path.exists(cfg_path) and os.path.exists(params_path)):
        return None
    with open(cfg_path) as f:
        blob = json.load(f)
    params = convert.load_params(path, name)
    if "out_dim" in blob:  # encoder family
        cfg = convert.load_config(path, name)
        return cfg, convert.flax_to_torch(params, cfg)
    fields = {f: int(blob[f]) for f in (
        "vocab_size", "hidden_dim", "num_layers", "num_heads", "mlp_dim",
        "max_seq_len")}
    fields["dtype"] = convert.config_dtype(blob)
    if "copy_dim" in blob:  # grounded pointer-generator family
        from optimized_rag_tpu_torch.models.grounded import GroundedConfig
        cfg = GroundedConfig(
            **fields, copy_dim=int(blob["copy_dim"]),
            prompt_len=int(blob.get("prompt_len",
                                    fields["max_seq_len"] - 320)),
            target_len=int(blob.get("target_len", 320)))
        return cfg, convert.grounded_flax_to_torch(params, cfg)
    from optimized_rag_tpu_torch.models.decoder import DecoderConfig
    cfg = DecoderConfig(**fields)
    return cfg, convert.decoder_flax_to_torch(params, cfg)


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
