"""LLaMA checkpoints: the HF state-dict names (the port's own parameter
names) <-> the JAX package's flax tree, and a reader of HF checkpoint
directories.

``llama_state_dict_to_flax`` is the JAX package's ``convert_llama``
(``iuvl_tpu/models/llm/convert.py``), copied; ``flax_to_llama_state_dict``
is its inverse. Both also carry the int8 tree of ``quant='int8'``
(``kernel_q`` / ``kernel_scale`` <-> ``weight`` / ``weight_scale``).
``load_hf_llama_params`` reads ``*.safetensors`` shards with a reader of
its own (an 8-byte little-endian header length, the JSON header, the raw
tensors) and ``pytorch_model*.bin`` through ``torch.load``; it needs
neither ``safetensors`` nor ``transformers``.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Mapping

import numpy as np
import torch

from .llama import PROJECTIONS

_ATTN = PROJECTIONS[:4]


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu()
        t = t if t.dtype == torch.int8 else t.float()
        return t.numpy()
    return np.asarray(t)


def state_dict_keys(layers: int) -> list[str]:
    """The HF names of a ``layers``-block model's weights."""
    keys = ["model.embed_tokens.weight", "model.norm.weight", "lm_head.weight"]
    for i in range(layers):
        h = f"model.layers.{i}"
        keys += [f"{h}.input_layernorm.weight", f"{h}.post_attention_layernorm.weight"]
        keys += [f"{h}.{'self_attn' if p in _ATTN else 'mlp'}.{p}.weight" for p in PROJECTIONS]
    return keys


def _proj_to_flax(sd: Mapping, key: str) -> dict:
    if key + "_scale" in sd:
        return {"kernel_q": _np(sd[key]).T, "kernel_scale": _np(sd[key + "_scale"])}
    return {"kernel": _np(sd[key]).T}


def llama_state_dict_to_flax(sd: Mapping, layers: int) -> dict:
    """HF names -> ``{'params': ...}`` numpy tree of JAX's
    ``LlamaForCausalLM`` (JAX's ``convert_llama``)."""
    p: dict = {
        "embed_tokens": _np(sd["model.embed_tokens.weight"]),
        "final_norm": {"weight": _np(sd["model.norm.weight"])},
        "lm_head": _np(sd["lm_head.weight"]).T,
    }
    for i in range(layers):
        h = f"model.layers.{i}"
        p[f"layer{i}"] = {
            "input_norm": {"weight": _np(sd[f"{h}.input_layernorm.weight"])},
            "post_attn_norm": {"weight": _np(sd[f"{h}.post_attention_layernorm.weight"])},
            "attn": {n: _proj_to_flax(sd, f"{h}.self_attn.{n}.weight") for n in _ATTN},
            **{n: _proj_to_flax(sd, f"{h}.mlp.{n}.weight") for n in PROJECTIONS[4:]},
        }
    return {"params": p}


def flax_to_llama_state_dict(params: Mapping, layers: int) -> dict:
    """JAX ``LlamaForCausalLM`` variables (``{'params': ...}`` or the inner
    tree; numpy or jax arrays) -> the port's state dict (CPU tensors)."""
    p = params.get("params", params)

    def t(x):
        return torch.from_numpy(np.array(x))

    sd = {"model.embed_tokens.weight": t(p["embed_tokens"]),
          "model.norm.weight": t(p["final_norm"]["weight"]),
          "lm_head.weight": t(np.asarray(p["lm_head"]).T)}
    for i in range(layers):
        h, f = f"model.layers.{i}", p[f"layer{i}"]
        sd[f"{h}.input_layernorm.weight"] = t(f["input_norm"]["weight"])
        sd[f"{h}.post_attention_layernorm.weight"] = t(f["post_attn_norm"]["weight"])
        for n in PROJECTIONS:
            leaf = f["attn"][n] if n in _ATTN else f[n]
            key = f"{h}.{'self_attn' if n in _ATTN else 'mlp'}.{n}.weight"
            if "kernel_q" in leaf:
                sd[key] = t(np.asarray(leaf["kernel_q"]).T)
                sd[key + "_scale"] = t(leaf["kernel_scale"])
            else:
                sd[key] = t(np.asarray(leaf["kernel"]).T)
    return sd


_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> dict:
    """Every tensor of one ``.safetensors`` file, as CPU tensors."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            begin, end = meta["data_offsets"]
            f.seek(base + begin)
            buf = bytearray(f.read(end - begin))
            dtype = _ST_DTYPES[meta["dtype"]]
            t = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
            out[name] = t.reshape(meta["shape"])
    return out


def load_hf_llama_params(path: str, cfg) -> dict:
    """An HF LLaMA / Vicuna checkpoint directory (``*.safetensors`` shards,
    else ``pytorch_model*.bin``) -> the port's state dict for ``cfg``'s
    model (CPU tensors in the file's dtype): the weights JAX's
    ``convert_llama`` reads, the others left out."""
    sd: dict = {}
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(f))
    else:
        bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
        if not bins:
            raise FileNotFoundError(f"no LLaMA weights under {path}")
        for f in bins:
            sd.update(torch.load(f, map_location="cpu"))
    return {k: sd[k] for k in state_dict_keys(cfg.layers)}
