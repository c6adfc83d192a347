"""Load the JAX package's checkpoints into the port, with numpy only.

Held against ``optimized_rag_tpu/models/loader.py`` (:22-51, the flattened
npz layout), ``models/pretrain.py`` (:330-383 ``load_pretrained``,
:412-423 ``load_tokenizer``), the parameter shapes of ``models/encoder.py``,
``models/decoder.py`` and ``models/grounded.py``, and the agent's
configuration of both encoders (``agent/agent.py:92-107``, ``:128-139``). A
checkpoint is ``<name>.config.json`` plus ``<name>.params.npz``, whose keys
are the Flax tree paths joined by ``/`` (``params/trunk/block_0/attn/query/
kernel``; a grounded checkpoint's under ``backbone/params/`` and
``heads/params/``), stored as float16 or float32. Weights are converted in
memory. The readers' inverses (``torch_to_flax``, ``decoder_torch_to_flax``,
``grounded_torch_to_flax``) give a trained model's state dict back in that
layout, which ``models/loader.save_params`` writes.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.models.loader import _flatten
from optimized_rag_tpu_torch.models.encoder import (
    CrossEncoderService, EmbeddingService, TransformerConfig)
from optimized_rag_tpu_torch.models.tokenizer import HashTokenizer


def _dense(prefix: str, kernel: np.ndarray, bias: np.ndarray) -> dict:
    """Flax Dense kernel [in, out] -> torch Linear weight [out, in]."""
    return {f"{prefix}.weight": kernel.T, f"{prefix}.bias": bias}


def _norm(prefix: str, p: dict) -> dict:
    return {f"{prefix}.scale": p["scale"], f"{prefix}.bias": p["bias"]}


def _tree(flat_params: dict[str, np.ndarray], prefix: str = "") -> dict:
    """The float32 tree of the flat npz keys under ``prefix``, without
    Flax's leading ``params``."""
    tree: dict = {}
    for key, val in flat_params.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        if parts[0] == "params":
            parts = parts[1:]
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.array(val, np.float32)
    return tree


def _tensors(arrays: dict, dtype_of) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype_of(k))
            for k, v in arrays.items()}


def _decoder_arrays(tree: dict, num_layers: int, prefix: str = "") -> dict:
    out = {f"{prefix}tok.weight": tree["tok"]["embedding"],
           f"{prefix}pos.weight": tree["pos"]["embedding"],
           **_norm(f"{prefix}ln_f", tree["ln_f"]),
           **_dense(f"{prefix}head", tree["head"]["kernel"],
                    tree["head"]["bias"])}
    for i in range(num_layers):
        blk, pre = tree[f"block_{i}"], f"{prefix}blocks.{i}"
        out.update(_norm(f"{pre}.ln1", blk["ln1"]))
        out.update(_norm(f"{pre}.ln2", blk["ln2"]))
        for name in ("qkv", "attn_out", "mlp_in", "mlp_out"):
            out.update(_dense(f"{pre}.{name}", blk[name]["kernel"],
                              blk[name]["bias"]))
    return out


def _decoder_dtype(cfg, prefix: str = ""):
    """The DecoderLM computes in cfg.dtype; LayerNorms and the head stay
    float32."""
    return lambda key: (torch.float32 if ".ln" in key or key.startswith(
        (f"{prefix}ln_f", f"{prefix}head")) else cfg.dtype)


def decoder_flax_to_torch(flat_params: dict[str, np.ndarray], cfg,
                          param_dtype=None) -> dict[str, torch.Tensor]:
    """DecoderLM state dict (``models/decoder.py``) from the flattened Flax
    params of a decoder checkpoint. Dense kernels [in, out] become Linear
    weights [out, in]; ``qkv``'s columns keep the reference's q | k | v,
    head-major order. Tensors come back on the CPU in the module's dtypes,
    or all in ``param_dtype`` (float32 for the training form).
    """
    return _tensors(_decoder_arrays(_tree(flat_params), cfg.num_layers),
                    _param_dtype(_decoder_dtype(cfg), param_dtype))


def grounded_flax_to_torch(flat_params: dict[str, np.ndarray], cfg,
                           param_dtype=None) -> dict[str, torch.Tensor]:
    """GroundedGenerator state dict (``backbone.*``, ``heads.*``) from the
    flattened params of a grounded checkpoint (``backbone/params/...``,
    ``heads/params/...``); the heads stay float32."""
    arrays = _decoder_arrays(_tree(flat_params, "backbone/"), cfg.num_layers,
                             "backbone.")
    heads = _tree(flat_params, "heads/")
    for name in ("copy_q", "copy_k", "p_gen"):
        arrays.update(_dense(f"heads.{name}", heads[name]["kernel"],
                             heads[name]["bias"]))
    dtype = _decoder_dtype(cfg, "backbone.")
    return _tensors(arrays, _param_dtype(lambda key: (
        torch.float32 if key.startswith("heads.") else dtype(key)),
        param_dtype))


def _param_dtype(dtype_of, param_dtype):
    """``dtype_of``, or every key in ``param_dtype`` when one is given."""
    return dtype_of if param_dtype is None else (lambda key: param_dtype)


def _numpy(state: dict) -> dict[str, np.ndarray]:
    return {k: v.detach().to("cpu", torch.float32).numpy()
            for k, v in state.items()}


def _kernel(state: dict, prefix: str, shape=None) -> dict:
    """Flax Dense params of the Linear ``prefix``: kernel [in, out]
    (reshaped to ``shape``), bias [out]."""
    kernel = state[f"{prefix}.weight"].T
    return {"kernel": kernel if shape is None else kernel.reshape(shape),
            "bias": state[f"{prefix}.bias"]}


def _norm_params(state: dict, prefix: str) -> dict:
    return {"scale": state[f"{prefix}.scale"],
            "bias": state[f"{prefix}.bias"]}


def _decoder_tree(state: dict, num_layers: int, prefix: str = "") -> dict:
    tree = {"tok": {"embedding": state[f"{prefix}tok.weight"]},
            "pos": {"embedding": state[f"{prefix}pos.weight"]},
            "ln_f": _norm_params(state, f"{prefix}ln_f"),
            "head": _kernel(state, f"{prefix}head")}
    for i in range(num_layers):
        pre = f"{prefix}blocks.{i}"
        tree[f"block_{i}"] = {
            "ln1": _norm_params(state, f"{pre}.ln1"),
            "ln2": _norm_params(state, f"{pre}.ln2"),
            **{name: _kernel(state, f"{pre}.{name}")
               for name in ("qkv", "attn_out", "mlp_in", "mlp_out")}}
    return tree


def decoder_torch_to_flax(state: dict, cfg) -> dict[str, np.ndarray]:
    """The inverse of ``decoder_flax_to_torch``: a DecoderLM state dict as
    the flattened float32 Flax params of a decoder checkpoint."""
    return _flatten({"params": _decoder_tree(_numpy(state), cfg.num_layers)})


def grounded_torch_to_flax(state: dict, cfg) -> dict[str, np.ndarray]:
    """The inverse of ``grounded_flax_to_torch``: ``backbone/params/...``
    and ``heads/params/...``, float32."""
    arrays = _numpy(state)
    heads = {name: _kernel(arrays, f"heads.{name}")
             for name in ("copy_q", "copy_k", "p_gen")}
    return _flatten({"backbone": {"params": _decoder_tree(
        arrays, cfg.num_layers, "backbone.")}, "heads": {"params": heads}})


def torch_to_flax(state: dict, cfg: TransformerConfig
                  ) -> dict[str, np.ndarray]:
    """The inverse of ``flax_to_torch``: a BiEncoder or CrossEncoder state
    dict as the flattened float32 Flax params (``params/trunk/...`` and the
    heads it holds), attention kernels back in [H, heads, head_dim] and
    [heads, head_dim, H], their biases in [heads, head_dim] and [H]."""
    a = _numpy(state)
    h, heads = cfg.hidden_dim, cfg.num_heads
    hd = h // heads
    trunk = {"emb": {"tok": {"embedding": a["trunk.emb.tok.weight"]},
                     "pos": {"embedding": a["trunk.emb.pos.weight"]},
                     "typ": {"embedding": a["trunk.emb.typ.weight"]},
                     "ln": _norm_params(a, "trunk.emb.ln")},
             "ln_f": _norm_params(a, "trunk.ln_f")}
    for i in range(cfg.num_layers):
        pre = f"trunk.blocks.{i}"
        attn = {}
        for name in ("query", "key", "value"):
            d = _kernel(a, f"{pre}.attn.{name}", (h, heads, hd))
            attn[name] = {"kernel": d["kernel"],
                          "bias": d["bias"].reshape(heads, hd)}
        attn["out"] = _kernel(a, f"{pre}.attn.out", (heads, hd, h))
        trunk[f"block_{i}"] = {
            "attn": attn, "ln1": _norm_params(a, f"{pre}.ln1"),
            "ln2": _norm_params(a, f"{pre}.ln2"),
            "mlp_in": _kernel(a, f"{pre}.mlp_in"),
            "mlp_out": _kernel(a, f"{pre}.mlp_out")}
    tree = {"trunk": trunk}
    for head in ("proj", "pool", "score"):
        if f"{head}.weight" in a:
            tree[head] = _kernel(a, head)
    return _flatten({"params": tree})


def flax_to_torch(flat_params: dict[str, np.ndarray],
                  cfg: TransformerConfig, param_dtype=None
                  ) -> dict[str, torch.Tensor]:
    """BiEncoder or CrossEncoder state dict from the flattened Flax params
    of the npz: the trunk, and the heads the params hold (``proj`` for the
    BiEncoder; ``pool`` and ``score`` for the CrossEncoder).

    Attention kernels are [H, heads, head_dim] for query/key/value and
    [heads, head_dim, H] for out; flattening (heads, head_dim) row-major
    gives the head-major feature order the torch module splits by.
    Tensors come back on the CPU in the module's dtypes, or all in
    ``param_dtype`` (float32 for the training form).
    """
    tree = _tree(flat_params)
    h = cfg.hidden_dim
    trunk = tree["trunk"]
    emb = trunk["emb"]
    out = {
        "trunk.emb.tok.weight": emb["tok"]["embedding"],
        "trunk.emb.pos.weight": emb["pos"]["embedding"],
        "trunk.emb.typ.weight": emb["typ"]["embedding"],
        **_norm("trunk.emb.ln", emb["ln"]),
        **_norm("trunk.ln_f", trunk["ln_f"]),
    }
    for head in ("proj", "pool", "score"):
        if head in tree:
            out.update(_dense(head, tree[head]["kernel"], tree[head]["bias"]))
    for i in range(cfg.num_layers):
        blk = trunk[f"block_{i}"]
        pre = f"trunk.blocks.{i}"
        attn = blk["attn"]
        for name in ("query", "key", "value"):
            out.update(_dense(f"{pre}.attn.{name}",
                              attn[name]["kernel"].reshape(h, h),
                              attn[name]["bias"].reshape(h)))
        out.update(_dense(f"{pre}.attn.out",
                          attn["out"]["kernel"].reshape(h, h),
                          attn["out"]["bias"]))
        out.update(_norm(f"{pre}.ln1", blk["ln1"]))
        out.update(_norm(f"{pre}.ln2", blk["ln2"]))
        out.update(_dense(f"{pre}.mlp_in", blk["mlp_in"]["kernel"],
                          blk["mlp_in"]["bias"]))
        out.update(_dense(f"{pre}.mlp_out", blk["mlp_out"]["kernel"],
                          blk["mlp_out"]["bias"]))
    # The trunk computes in cfg.dtype; norms and heads stay float32.
    return _tensors(out, _param_dtype(lambda key: (
        cfg.dtype if key.startswith("trunk.") and ".ln" not in key
        else torch.float32), param_dtype))


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def config_dtype(blob: dict) -> torch.dtype:
    """The compute dtype a checkpoint's config names (bfloat16 unless it
    says float32 or float16)."""
    return _DTYPES.get(str(blob.get("dtype", "bfloat16")), torch.bfloat16)


def dtype_name(dtype: torch.dtype) -> str:
    """The name a checkpoint's config gives ``dtype`` (``config_dtype``'s
    inverse)."""
    return next((k for k, v in _DTYPES.items() if v == dtype), "bfloat16")


def load_config(ckpt_dir: str, name: str = "biencoder") -> TransformerConfig:
    with open(os.path.join(ckpt_dir, f"{name}.config.json")) as f:
        blob = json.load(f)
    dtype = config_dtype(blob)
    return TransformerConfig(
        vocab_size=int(blob["vocab_size"]),
        hidden_dim=int(blob["hidden_dim"]),
        num_layers=int(blob["num_layers"]),
        num_heads=int(blob["num_heads"]),
        mlp_dim=int(blob["mlp_dim"]),
        max_seq_len=int(blob["max_seq_len"]),
        num_types=int(blob.get("num_types", 2)),
        out_dim=int(blob["out_dim"]),
        dtype=dtype)


def load_params(ckpt_dir: str, name: str = "biencoder") -> dict:
    with np.load(os.path.join(ckpt_dir, f"{name}.params.npz")) as z:
        return {k: z[k] for k in z.files}


def load_tokenizer(ckpt_dir: str | None, vocab_size: int,
                   max_len: int = 512):
    """The checkpoint's tokenizer: its learned vocab when
    ``tokenizer.vocab.txt`` is present, else the hashing tokenizer."""
    if ckpt_dir:
        path = os.path.join(ckpt_dir, "tokenizer.vocab.txt")
        if os.path.exists(path):
            return HashTokenizer.load(path, vocab_size, max_len)
    return HashTokenizer(vocab_size, max_len)


def load_biencoder(ckpt_dir: str, device="cuda",
                   cache_size: int = 4096) -> EmbeddingService:
    """The checkpoint's BiEncoder as an embedding service on ``device``,
    configured as the agent does (``agent/agent.py:92-107``): the
    checkpoint's own config, max_len min(max_seq_len, 128) and its
    tokenizer."""
    device = resolve_device(device)
    cfg = load_config(ckpt_dir)
    max_len = min(cfg.max_seq_len, 128)
    return EmbeddingService(
        cfg, params=flax_to_torch(load_params(ckpt_dir), cfg),
        cache_size=cache_size, max_len=max_len,
        tokenizer=load_tokenizer(ckpt_dir, cfg.vocab_size, max_len),
        device=device)


def load_crossencoder(ckpt_dir: str, device="cuda") -> CrossEncoderService:
    """The checkpoint's CrossEncoder as a scoring service on ``device``,
    configured as the agent does (``agent/agent.py:128-139``): the
    checkpoint's own config, max_len min(max_seq_len, 256) and its
    tokenizer."""
    device = resolve_device(device)
    cfg = load_config(ckpt_dir, "crossencoder")
    max_len = min(cfg.max_seq_len, 256)
    return CrossEncoderService(
        cfg, params=flax_to_torch(load_params(ckpt_dir, "crossencoder"), cfg),
        max_len=max_len,
        tokenizer=load_tokenizer(ckpt_dir, cfg.vocab_size, max_len),
        device=device)
