"""Weight bridge: the JAX package's SAM parameters <-> this port's state_dict.

The exact inverse of ``iuvl_tpu/models/sam/convert.py`` (which maps the
reference SAM state dict onto the flax tree): flax ``kernel`` layouts go
back to PyTorch's, and the flax names back to the reference state-dict
names. Because the port uses those names, a reference SAM ``.pth`` loads
as is (:func:`load_sam_checkpoint`). Pure numpy in, torch tensors out, and
back (:func:`state_dict_to_flax`).

The bridge is a table of entries ``(port key, flax path, kind)``, read in
both directions:

- ``linear``: Dense kernel (in, out)                    <-> weight (out, in)
- ``conv``:   Conv kernel (kh, kw, in, out)             <-> weight (out, in, kh, kw);
              ConvTranspose kernel (kh, kw, out, in)    <-> weight (in, out, kh, kw)
- ``dense1x1``: 1x1 Conv kernel (1, 1, in, out)       <-> nn.Linear weight (out, in)
- ``copy``:   the same array
- ``rows``:   one (n, C) array <-> n port keys of (1, C) (``point_embeddings``)

The table does not depend on ``attn_impl``: the fused route ('auto',
'plain') and JAX's unfused one ('rowbias', 'pallas_rp') read the same
parameters (qkv, proj, rel_pos_h/w, norm2, mlp), as the JAX modules keep one
tree for every impl.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

Entry = tuple  # (port key, or a tuple of keys for "rows"; flax path tuple; kind)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def linear(entries: list, port: str, flax: tuple, bias: bool = True) -> None:
    entries.append((f"{port}.weight", flax + ("kernel",), "linear"))
    if bias:
        entries.append((f"{port}.bias", flax + ("bias",), "copy"))


def conv(entries: list, port: str, flax: tuple, bias: bool = True) -> None:
    entries.append((f"{port}.weight", flax + ("kernel",), "conv"))
    if bias:
        entries.append((f"{port}.bias", flax + ("bias",), "copy"))


def norm(entries: list, port: str, flax: tuple, scale: str = "scale") -> None:
    """LayerNorm / GroupNorm (flax ``scale``) or SAM LayerNorm2d (``weight``)."""
    entries.append((f"{port}.weight", flax + (scale,), "copy"))
    entries.append((f"{port}.bias", flax + ("bias",), "copy"))


def copy(entries: list, port: str, flax: tuple) -> None:
    entries.append((port, flax, "copy"))


_FPN = (  # flax name -> (reference name, kind)
    ("down4_deconv1", "neck.down_4.0", conv), ("down4_gn1", "neck.down_4.1", norm),
    ("down4_deconv2", "neck.down_4.3", conv), ("down4_gn2", "neck.down_4.4", norm),
    ("down4_conv", "neck.down_4.5", conv), ("down4_gn3", "neck.down_4.6", norm),
    ("down8_deconv", "neck.down_8.0", conv), ("down8_gn1", "neck.down_8.1", norm),
    ("down8_conv", "neck.down_8.2", conv), ("down8_gn2", "neck.down_8.3", norm),
    ("down16_conv", "neck.down_16.0", conv), ("down16_gn", "neck.down_16.1", norm),
    ("down32_conv1", "neck.down_32.0", conv), ("down32_gn1", "neck.down_32.1", norm),
    ("down32_conv2", "neck.down_32.2", conv), ("down32_gn2", "neck.down_32.3", norm),
)


def image_encoder_entries(depth: int, prefix: str = "image_encoder.",
                          flax: tuple = ("image_encoder",)) -> list:
    e: list = []
    g = lambda k: f"{prefix}{k}"  # noqa: E731
    conv(e, g("patch_embed.proj"), flax + ("patch_embed",))
    copy(e, g("pos_embed"), flax + ("pos_embed",))
    conv(e, g("orig_neck.0"), flax + ("neck_conv1",), bias=False)
    norm(e, g("orig_neck.1"), flax + ("neck_ln1",), scale="weight")
    conv(e, g("orig_neck.2"), flax + ("neck_conv2",), bias=False)
    norm(e, g("orig_neck.3"), flax + ("neck_ln2",), scale="weight")
    for i in range(depth):
        b, blk = g(f"blocks.{i}"), flax + (f"block{i}",)
        norm(e, f"{b}.norm1", blk + ("norm1",))
        norm(e, f"{b}.norm2", blk + ("norm2",))
        linear(e, f"{b}.attn.qkv", blk + ("attn", "qkv"))
        linear(e, f"{b}.attn.proj", blk + ("attn", "proj"))
        copy(e, f"{b}.attn.rel_pos_h", blk + ("attn", "rel_pos_h"))
        copy(e, f"{b}.attn.rel_pos_w", blk + ("attn", "rel_pos_w"))
        linear(e, f"{b}.mlp.lin1", blk + ("mlp_lin1",))
        linear(e, f"{b}.mlp.lin2", blk + ("mlp_lin2",))
    for flax_name, ref_name, kind in _FPN:
        kind(e, g(ref_name), flax + ("fpn", flax_name))
    return e


def prompt_encoder_entries(prefix: str = "prompt_encoder.",
                           flax: tuple = ("prompt_encoder",), n_points: int = 4) -> list:
    e: list = []
    g = lambda k: f"{prefix}{k}"  # noqa: E731
    copy(e, g("pe_layer.positional_encoding_gaussian_matrix"),
         flax + ("pe_layer", "gaussian_matrix"))
    e.append((tuple(g(f"point_embeddings.{i}.weight") for i in range(n_points)),
              flax + ("point_embeddings",), "rows"))
    copy(e, g("not_a_point_embed.weight"), flax + ("not_a_point_embed",))
    copy(e, g("no_mask_embed.weight"), flax + ("no_mask_embed",))
    conv(e, g("mask_downscaling.0"), flax + ("mask_conv1",))
    norm(e, g("mask_downscaling.1"), flax + ("mask_ln1",), scale="weight")
    conv(e, g("mask_downscaling.3"), flax + ("mask_conv2",))
    norm(e, g("mask_downscaling.4"), flax + ("mask_ln2",), scale="weight")
    conv(e, g("mask_downscaling.6"), flax + ("mask_conv3",))
    return e


def _attn(e, port, flax):
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        linear(e, f"{port}.{name}", flax + (name,))


def _mlp(e, port, flax, layers=3):
    for j in range(layers):
        linear(e, f"{port}.layers.{j}", flax + (f"lin{j}",))


def mask_decoder_entries(prefix: str = "mask_decoder.", flax: tuple = ("mask_decoder",),
                         depth: int = 2, n_masks: int = 4) -> list:
    e: list = []
    g = lambda k: f"{prefix}{k}"  # noqa: E731
    tr = flax + ("transformer",)
    for i in range(depth):
        t, lay = g(f"transformer.layers.{i}"), tr + (f"layer{i}",)
        _attn(e, f"{t}.self_attn", lay + ("self_attn",))
        norm(e, f"{t}.norm1", lay + ("norm1",))
        _attn(e, f"{t}.cross_attn_token_to_image", lay + ("cross_attn_t2i",))
        norm(e, f"{t}.norm2", lay + ("norm2",))
        linear(e, f"{t}.mlp.lin1", lay + ("mlp_lin1",))
        linear(e, f"{t}.mlp.lin2", lay + ("mlp_lin2",))
        norm(e, f"{t}.norm3", lay + ("norm3",))
        _attn(e, f"{t}.cross_attn_image_to_token", lay + ("cross_attn_i2t",))
        norm(e, f"{t}.norm4", lay + ("norm4",))
    _attn(e, g("transformer.final_attn_token_to_image"), tr + ("final_attn_t2i",))
    norm(e, g("transformer.norm_final_attn"), tr + ("norm_final_attn",))
    copy(e, g("iou_token.weight"), flax + ("iou_token",))
    copy(e, g("mask_tokens.weight"), flax + ("mask_tokens",))
    conv(e, g("output_upscaling.0"), flax + ("upscale_deconv1",))
    norm(e, g("output_upscaling.1"), flax + ("upscale_ln",), scale="weight")
    conv(e, g("output_upscaling.3"), flax + ("upscale_deconv2",))
    _mlp(e, g("iou_prediction_head"), flax + ("iou_head",))
    for i in range(n_masks):
        _mlp(e, g(f"output_hypernetworks_mlps.{i}"), flax + (f"hyper_mlp{i}",))
    return e


def sam_entries(depth: int = 12) -> list:
    return image_encoder_entries(depth) + prompt_encoder_entries() + mask_decoder_entries()


# kind -> (flax array -> port array, port array -> flax array)
KINDS = {
    "linear": (lambda a: a.T, lambda a: a.T),
    "conv": (lambda a: a.transpose(3, 2, 0, 1), lambda a: a.transpose(2, 3, 1, 0)),
    "dense1x1": (lambda a: a[0, 0].T, lambda a: a.T[None, None]),
    "copy": (lambda a: a, lambda a: a),
}


def _get(tree: Mapping, path: Sequence[str]):
    for key in path:
        tree = tree[key]
    return tree


def to_port(params: Mapping, entries: Sequence[Entry]) -> dict:
    """flax tree (the inner ``params`` dict, numpy or jax arrays) -> a state
    dict of the keys in ``entries``."""
    sd: dict = {}
    for port, flax, kind in entries:
        x = np.asarray(_get(params, flax))
        if kind == "rows":
            for i, key in enumerate(port):
                sd[key] = _t(x[i:i + 1])
        else:
            sd[port] = _t(KINDS[kind][0](x))
    return sd


def to_flax(sd: Mapping, entries: Sequence[Entry]) -> dict:
    """The inverse of :func:`to_port`: a nested dict of numpy fp32 arrays."""
    tree: dict = {}
    arr = lambda key: sd[key].detach().cpu().float().numpy()  # noqa: E731
    for port, flax, kind in entries:
        if kind == "rows":
            x = np.concatenate([arr(key) for key in port], axis=0)
        else:
            x = KINDS[kind][1](arr(port))
        node = tree
        for key in flax[:-1]:
            node = node.setdefault(key, {})
        node[flax[-1]] = np.array(x, dtype=np.float32, order="C")
    return tree


def flax_to_state_dict(params: Mapping, depth: int = 12) -> dict:
    """JAX ``Sam`` variables (``{'params': ...}`` or the inner tree, arrays
    as numpy or jax arrays) -> this port's ``Sam`` state_dict."""
    return to_port(params.get("params", params), sam_entries(depth))


def state_dict_to_flax(sd: Mapping, depth: int = 12) -> dict:
    """This port's ``Sam`` state_dict -> the JAX ``Sam`` parameter tree
    (``{'params': ...}``, numpy)."""
    return {"params": to_flax(sd, sam_entries(depth))}


def load_sam_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference SAM ``.pth`` state dict into ``model`` (strict)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model.load_state_dict(sd, strict=True)
    return model
