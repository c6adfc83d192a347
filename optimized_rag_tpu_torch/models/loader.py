"""Model parameter persistence and (optional) HF BERT weight import.

Held against ``optimized_rag_tpu/models/loader.py`` (:1-113). Persistence is
the flattened npz of the JAX package: the keys are the Flax tree paths
joined by ``/`` (``models/convert.torch_to_flax`` gives a port model's
parameters in that layout), written with ``np.savez_compressed``, so both
packages read each other's files.

``import_hf_bert`` maps a BERT-family state dict that the caller already
holds (a local model directory; nothing is fetched) onto the port's
``trunk.*`` keys, through the same mapping as the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict):
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)
    return tree


def save_params(path: str, name: str, params) -> None:
    """``params``: a nested dict of arrays, or one already flat."""
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(os.path.join(path, f"{name}.params.npz"),
                        **_flatten(params))


def load_params(path: str, name: str):
    """The nested dict of numpy arrays that ``save_params`` wrote."""
    with np.load(os.path.join(path, f"{name}.params.npz")) as z:
        return _unflatten({k: z[k] for k in z.files})


# ---------------------------------------------------------------------------
# HuggingFace BERT import
# ---------------------------------------------------------------------------

def _hf_trunk(t, num_layers: int, num_heads: int, hidden_dim: int) -> dict:
    """The JAX package's trunk subtree of a BERT state dict (``t(name)``
    reads one weight as numpy)."""
    head_dim = hidden_dim // num_heads
    trunk = {
        "emb": {
            "tok": {"embedding": t("embeddings.word_embeddings.weight")},
            "pos": {"embedding": t("embeddings.position_embeddings.weight")},
            "typ": {"embedding": t("embeddings.token_type_embeddings.weight")},
            "ln": {"scale": t("embeddings.LayerNorm.weight"),
                   "bias": t("embeddings.LayerNorm.bias")},
        },
        "ln_f": {"scale": np.ones(hidden_dim, np.float32),
                 "bias": np.zeros(hidden_dim, np.float32)},
    }
    for i in range(num_layers):
        pre = f"encoder.layer.{i}."
        qkv = {}
        for name, hf in (("query", "attention.self.query"),
                         ("key", "attention.self.key"),
                         ("value", "attention.self.value")):
            w = t(pre + hf + ".weight").T        # [hidden, hidden]
            b = t(pre + hf + ".bias")
            qkv[name] = {
                "kernel": w.reshape(hidden_dim, num_heads, head_dim),
                "bias": b.reshape(num_heads, head_dim),
            }
        out_w = t(pre + "attention.output.dense.weight").T
        qkv["out"] = {
            "kernel": out_w.reshape(num_heads, head_dim, hidden_dim),
            "bias": t(pre + "attention.output.dense.bias"),
        }
        trunk[f"block_{i}"] = {
            "attn": qkv,
            "ln1": {"scale": t(pre + "attention.output.LayerNorm.weight"),
                    "bias": t(pre + "attention.output.LayerNorm.bias")},
            "ln2": {"scale": t(pre + "output.LayerNorm.weight"),
                    "bias": t(pre + "output.LayerNorm.bias")},
            "mlp_in": {"kernel": t(pre + "intermediate.dense.weight").T,
                       "bias": t(pre + "intermediate.dense.bias")},
            "mlp_out": {"kernel": t(pre + "output.dense.weight").T,
                        "bias": t(pre + "output.dense.bias")},
        }
    return trunk


def import_hf_bert(state_dict: dict, num_layers: int, num_heads: int,
                   hidden_dim: int, trunk_key: str = "trunk",
                   hf_prefix: str = "") -> dict[str, torch.Tensor]:
    """Map a torch BERT state_dict onto the port's trunk parameters.

    Returns float32 tensors under ``<trunk_key>.*`` (embeddings, blocks and
    a unit final LayerNorm; the caller keeps its own heads), ready for
    ``load_state_dict(..., strict=False)``. HF BERT is post-LN while this
    trunk is pre-LN: the weights transfer for warm-starting only.
    """
    from optimized_rag_tpu_torch.models.convert import flax_to_torch
    from optimized_rag_tpu_torch.models.encoder import TransformerConfig

    def t(name):
        arr = state_dict[hf_prefix + name]
        return np.asarray(arr.detach().cpu().numpy()
                          if hasattr(arr, "detach") else arr, np.float32)

    trunk = _hf_trunk(t, num_layers, num_heads, hidden_dim)
    cfg = TransformerConfig(hidden_dim=hidden_dim, num_layers=num_layers,
                            num_heads=num_heads)  # what the mapping reads
    state = flax_to_torch(_flatten({"params": {"trunk": trunk}}), cfg,
                          param_dtype=torch.float32)
    return {trunk_key + key[len("trunk"):]: val
            for key, val in state.items()}
