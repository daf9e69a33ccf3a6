"""Weight bridge: the JAX package's ``SysLearner`` parameters <-> this
port's state_dict.

The JAX package has no X-Decoder converter of its own (it never loaded a
PyTorch checkpoint of it), so the port's parameter names are its own. They
follow the flax tree, with PyTorch's conventions:

- flax ``name{i}`` is port ``name.{i}`` (``input_proj0`` -> ``input_proj.0``,
  ``layer3`` -> ``layers.3``);
- Dense ``kernel`` (in, out) is ``nn.Linear.weight`` (out, in); 1x1 convs
  (``input_proj*``, ``fpn_lateral``, ``mask_features``) are ``nn.Linear``
  too; the 3x3 ``fpn_output`` is an ``nn.Conv2d``;
- LayerNorm / GroupNorm / the text tower's TFLayerNorm ``scale`` is
  ``weight``;
- the raw tables (``query_feat``, ``class_embed`` (hidden, dim_proj),
  ``token_embedding``, ``lang_proj`` (width, proj), ...) keep their flax
  layout.

The SAM part (image encoder with its SimpleFPN, prompt encoder, mask
decoder) is ``models/sam/convert.py``'s table under the same prefixes.
Every flax leaf of the model maps to exactly one port parameter, and back.
"""

from __future__ import annotations

from typing import Mapping

from ..sam import convert as sam_convert
from ..sam.build import SAM_VARIANTS
from ..sam.convert import copy, conv, linear, norm
from .model import SysLearnerConfig

def _dense1x1(e: list, port: str, flax: tuple, bias: bool = True) -> None:
    e.append((f"{port}.weight", flax + ("kernel",), "dense1x1"))
    if bias:
        e.append((f"{port}.bias", flax + ("bias",), "copy"))


def pixel_decoder_entries(num_layers: int, prefix: str = "pixel_decoder.",
                          flax: tuple = ("pixel_decoder",)) -> list:
    e: list = []
    for i in range(3):
        _dense1x1(e, f"{prefix}input_proj.{i}", flax + (f"input_proj{i}",))
        norm(e, f"{prefix}input_gn.{i}", flax + (f"input_gn{i}",))
    copy(e, f"{prefix}level_embed", flax + ("level_embed",))
    for i in range(num_layers):
        p, f = f"{prefix}layers.{i}", flax + (f"layer{i}",)
        for name in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
            linear(e, f"{p}.self_attn.{name}", f + ("self_attn", name))
        norm(e, f"{p}.norm1", f + ("norm1",))
        linear(e, f"{p}.linear1", f + ("linear1",))
        linear(e, f"{p}.linear2", f + ("linear2",))
        norm(e, f"{p}.norm2", f + ("norm2",))
    _dense1x1(e, f"{prefix}fpn_lateral", flax + ("fpn_lateral",), bias=False)
    norm(e, f"{prefix}fpn_lateral_gn", flax + ("fpn_lateral_gn",))
    conv(e, f"{prefix}fpn_output", flax + ("fpn_output",), bias=False)
    norm(e, f"{prefix}fpn_output_gn", flax + ("fpn_output_gn",))
    _dense1x1(e, f"{prefix}mask_features", flax + ("mask_features",))
    return e


def predictor_entries(num_layers: int = 9, prefix: str = "predictor.",
                      flax: tuple = ("predictor",)) -> list:
    e: list = []
    for name in ("query_feat", "query_embed", "level_embed", "class_embed", "caping_embed",
                 "pos_embed_caping"):
        copy(e, prefix + name, flax + (name,))
    for i in range(num_layers):
        p, f = f"{prefix}layers.{i}", flax + (f"layer{i}",)
        for attn in ("cross_attn", "self_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                linear(e, f"{p}.{attn}.{proj}", f + (attn, proj))
        for n in ("cross_norm", "self_norm", "ffn_norm"):
            norm(e, f"{p}.{n}", f + (n,))
        linear(e, f"{p}.ffn_lin1", f + ("ffn_lin1",))
        linear(e, f"{p}.ffn_lin2", f + ("ffn_lin2",))
    norm(e, f"{prefix}decoder_norm", flax + ("decoder_norm",))
    for j in range(3):
        linear(e, f"{prefix}mask_embed.lin{j}", flax + ("mask_embed", f"lin{j}"))
    linear(e, f"{prefix}sam_query_proj", flax + ("sam_query_proj",))
    linear(e, f"{prefix}sam_feat_proj", flax + ("sam_feat_proj",))
    return e


def lang_encoder_entries(num_layers: int, prefix: str = "lang_encoder.",
                         flax: tuple = ("lang_encoder",)) -> list:
    e: list = []
    tower, ftower = prefix + "lang_encoder.", flax + ("lang_encoder",)
    copy(e, tower + "token_embedding", ftower + ("token_embedding",))
    copy(e, tower + "positional_embedding", ftower + ("positional_embedding",))
    for i in range(num_layers):
        p, f = f"{tower}blocks.{i}", ftower + (f"block{i}",)
        for n in ("ln_1", "ln_2"):
            norm(e, f"{p}.{n}", f + (n,))
        for n in ("in_proj", "out_proj", "c_fc", "c_proj"):
            linear(e, f"{p}.{n}", f + (n,))
    norm(e, tower + "ln_final", ftower + ("ln_final",))
    copy(e, prefix + "lang_proj", flax + ("lang_proj",))
    copy(e, prefix + "logit_scale", flax + ("logit_scale",))
    return e


def entries(cfg: SysLearnerConfig) -> list:
    """The bridge table of ``cfg``'s SysLearner."""
    e = sam_convert.sam_entries(SAM_VARIANTS[cfg.sam_size]["depth"])
    e += pixel_decoder_entries(cfg.pixel_decoder_layers)
    e += predictor_entries()
    e += lang_encoder_entries(cfg.text_layers)
    if cfg.retrieval_ensemble:
        linear(e, "backbone_proj", ("backbone_proj",), bias=False)
    if cfg.llm_dim:
        linear(e, "img_to_lang", ("img_to_lang",))
    return e


def flax_to_state_dict(params: Mapping, cfg: SysLearnerConfig) -> dict:
    """JAX ``SysLearner`` variables (``{'params': ...}`` or the inner tree;
    numpy or jax arrays) -> the port's ``SysLearner`` state_dict."""
    return sam_convert.to_port(params.get("params", params), entries(cfg))


def state_dict_to_flax(sd: Mapping, cfg: SysLearnerConfig) -> dict:
    """The port's state_dict -> ``{'params': ...}`` numpy tree."""
    return {"params": sam_convert.to_flax(sd, entries(cfg))}


def flax_paths(cfg: SysLearnerConfig) -> dict[str, str]:
    """Port parameter name -> its flax path (``image_encoder/block0/...``),
    the names the optimizer's decay and multiplier rules read."""
    out = {}
    for port, flax, _ in entries(cfg):
        for key in (port if isinstance(port, tuple) else (port,)):
            out[key] = "/".join(flax)
    return out
