"""Weight bridge: the JAX package's SAM parameters -> this port's state_dict.

The exact inverse of ``iuvl_tpu/models/sam/convert.py`` (which maps the
reference SAM state dict onto the flax tree): flax ``kernel`` layouts go
back to PyTorch's, and the flax names back to the reference state-dict
names. Because the port uses those names, a reference SAM ``.pth`` loads
as is (:func:`load_sam_checkpoint`). Pure numpy in, torch tensors out.

- Linear:          kernel (in, out)          -> weight (out, in)
- Conv2d:          kernel (kh, kw, in, out)  -> weight (out, in, kh, kw)
- ConvTranspose2d: kernel (kh, kw, out, in)  -> weight (in, out, kh, kw)
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd, prefix, p):
    # also the inverse for ConvTranspose: both were stored transpose(2, 3, 1, 0)
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln2d(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["weight"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


_FPN = (  # flax name -> (reference name, kind)
    ("down4_deconv1", "neck.down_4.0", _conv), ("down4_gn1", "neck.down_4.1", _ln),
    ("down4_deconv2", "neck.down_4.3", _conv), ("down4_gn2", "neck.down_4.4", _ln),
    ("down4_conv", "neck.down_4.5", _conv), ("down4_gn3", "neck.down_4.6", _ln),
    ("down8_deconv", "neck.down_8.0", _conv), ("down8_gn1", "neck.down_8.1", _ln),
    ("down8_conv", "neck.down_8.2", _conv), ("down8_gn2", "neck.down_8.3", _ln),
    ("down16_conv", "neck.down_16.0", _conv), ("down16_gn", "neck.down_16.1", _ln),
    ("down32_conv1", "neck.down_32.0", _conv), ("down32_gn1", "neck.down_32.1", _ln),
    ("down32_conv2", "neck.down_32.2", _conv), ("down32_gn2", "neck.down_32.3", _ln),
)


def image_encoder_state(p: Mapping, depth: int, prefix: str = "image_encoder.") -> dict:
    sd: dict = {}
    g = lambda k: f"{prefix}{k}"  # noqa: E731
    _conv(sd, g("patch_embed.proj"), p["patch_embed"])
    sd[g("pos_embed")] = _t(p["pos_embed"])
    _conv(sd, g("orig_neck.0"), p["neck_conv1"])
    _ln2d(sd, g("orig_neck.1"), p["neck_ln1"])
    _conv(sd, g("orig_neck.2"), p["neck_conv2"])
    _ln2d(sd, g("orig_neck.3"), p["neck_ln2"])
    for i in range(depth):
        b, blk = g(f"blocks.{i}"), p[f"block{i}"]
        _ln(sd, f"{b}.norm1", blk["norm1"])
        _ln(sd, f"{b}.norm2", blk["norm2"])
        _linear(sd, f"{b}.attn.qkv", blk["attn"]["qkv"])
        _linear(sd, f"{b}.attn.proj", blk["attn"]["proj"])
        sd[f"{b}.attn.rel_pos_h"] = _t(blk["attn"]["rel_pos_h"])
        sd[f"{b}.attn.rel_pos_w"] = _t(blk["attn"]["rel_pos_w"])
        _linear(sd, f"{b}.mlp.lin1", blk["mlp_lin1"])
        _linear(sd, f"{b}.mlp.lin2", blk["mlp_lin2"])
    for flax_name, ref_name, kind in _FPN:
        kind(sd, g(ref_name), p["fpn"][flax_name])
    return sd


def prompt_encoder_state(p: Mapping, prefix: str = "prompt_encoder.") -> dict:
    sd: dict = {}
    g = lambda k: f"{prefix}{k}"  # noqa: E731
    sd[g("pe_layer.positional_encoding_gaussian_matrix")] = _t(
        p["pe_layer"]["gaussian_matrix"])
    pts = np.asarray(p["point_embeddings"])
    for i in range(pts.shape[0]):
        sd[g(f"point_embeddings.{i}.weight")] = _t(pts[i:i + 1])
    sd[g("not_a_point_embed.weight")] = _t(p["not_a_point_embed"])
    sd[g("no_mask_embed.weight")] = _t(p["no_mask_embed"])
    _conv(sd, g("mask_downscaling.0"), p["mask_conv1"])
    _ln2d(sd, g("mask_downscaling.1"), p["mask_ln1"])
    _conv(sd, g("mask_downscaling.3"), p["mask_conv2"])
    _ln2d(sd, g("mask_downscaling.4"), p["mask_ln2"])
    _conv(sd, g("mask_downscaling.6"), p["mask_conv3"])
    return sd


def _attn(sd, prefix, p):
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(sd, f"{prefix}.{name}", p[name])


def _mlp(sd, prefix, p):
    for j in range(len(p)):
        _linear(sd, f"{prefix}.layers.{j}", p[f"lin{j}"])


def mask_decoder_state(p: Mapping, prefix: str = "mask_decoder.", depth: int = 2) -> dict:
    sd: dict = {}
    g = lambda k: f"{prefix}{k}"  # noqa: E731
    tr = p["transformer"]
    for i in range(depth):
        t, lay = g(f"transformer.layers.{i}"), tr[f"layer{i}"]
        _attn(sd, f"{t}.self_attn", lay["self_attn"])
        _ln(sd, f"{t}.norm1", lay["norm1"])
        _attn(sd, f"{t}.cross_attn_token_to_image", lay["cross_attn_t2i"])
        _ln(sd, f"{t}.norm2", lay["norm2"])
        _linear(sd, f"{t}.mlp.lin1", lay["mlp_lin1"])
        _linear(sd, f"{t}.mlp.lin2", lay["mlp_lin2"])
        _ln(sd, f"{t}.norm3", lay["norm3"])
        _attn(sd, f"{t}.cross_attn_image_to_token", lay["cross_attn_i2t"])
        _ln(sd, f"{t}.norm4", lay["norm4"])
    _attn(sd, g("transformer.final_attn_token_to_image"), tr["final_attn_t2i"])
    _ln(sd, g("transformer.norm_final_attn"), tr["norm_final_attn"])
    sd[g("iou_token.weight")] = _t(p["iou_token"])
    sd[g("mask_tokens.weight")] = _t(p["mask_tokens"])
    _conv(sd, g("output_upscaling.0"), p["upscale_deconv1"])
    _ln2d(sd, g("output_upscaling.1"), p["upscale_ln"])
    _conv(sd, g("output_upscaling.3"), p["upscale_deconv2"])
    _mlp(sd, g("iou_prediction_head"), p["iou_head"])
    n_masks = sum(1 for k in p if k.startswith("hyper_mlp"))
    for i in range(n_masks):
        _mlp(sd, g(f"output_hypernetworks_mlps.{i}"), p[f"hyper_mlp{i}"])
    return sd


def flax_to_state_dict(params: Mapping, depth: int = 12) -> dict:
    """JAX ``Sam`` variables (``{'params': ...}`` or the inner tree, arrays
    as numpy or jax arrays) -> this port's ``Sam`` state_dict."""
    p = params.get("params", params)
    return {
        **image_encoder_state(p["image_encoder"], depth),
        **prompt_encoder_state(p["prompt_encoder"]),
        **mask_decoder_state(p["mask_decoder"]),
    }


def load_sam_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference SAM ``.pth`` state dict into ``model`` (strict)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model.load_state_dict(sd, strict=True)
    return model
