"""SAM ViT image encoder (ImageEncoderViT + SimpleFPN), PyTorch port.

Counterpart of ``iuvl_tpu/models/sam/image_encoder.py``: patch embed ->
abs pos -> depth x blocks (windowed attention with decomposed rel-pos bias,
a few global blocks) -> the 256-ch SAM neck (``orig_neck``) and the
four-branch SimpleFPN (``neck``). Parameter names are the reference SAM
state-dict names; tensors are NHWC at the public functions, as in JAX.

Kernels on this path, chosen with ``attn_impl='auto'`` (``'plain'`` runs
their plain versions):

- serving (no gradient recorded): the windowed attention body (B1), the
  global attention + projection (B2) and every block tail (B3), on weight
  layouts cached per weight state (``ops.common.prepared``);
- training (autograd records the call, ``ops.common.needs_grad``): B1 with
  its backward B9, the augmented global attention B11 (forward and
  backward) with the projection in PyTorch, and B3 with its backward B10,
  on layouts made from the parameters inside the graph, so that every
  parameter gets its gradient.

``attn_impl='rowbias'``, ``'pallas_rp'``, ``'window'`` and ``'pallas'``
take JAX's unfused route in every block, as its encoder does under those
impls (``use_block`` and ``use_tail`` need ``'auto'`` or ``'block'``): the
qkv projection as a plain matmul, the attention through one kernel, then
the relayout and the projection, and the plain block tail with autograd's
backward. The attention kernel: B2b (``'rowbias'``) or B14
(``'pallas_rp'``), forward and backward; B13 (``'window'``), whose backward
is autograd of the plain augmented route, as in JAX; B11 on the augmented
q, k (``'pallas'``), or the materialised-bias oracle (``'xla_naive'``).
``'window_plain'`` is the same route with B13's plain version, the card's
reference for ``'window'``. JAX's ``'block'`` runs as
``'auto'`` and its ``'xla'`` as ``'plain'``. Every impl reads the
same parameters, so the weight bridge (``convert.py``) is the same for all.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.common import (conv_nhwc, conv_transpose_nhwc, gelu, group_norm_f32,
                           layer_norm_2d, layer_norm_f32, linear, needs_grad, prepared)
from ...ops.cuda.mlp_block import block_tail, block_tail_plain, block_tail_train
from ...ops.cuda.window_block import (window_attention_block,
                                      window_attention_block_plain,
                                      window_attention_block_train)
from ...ops.rel_pos_attention import rel_pos_attention_proj, rel_pos_tables
from ...ops.resize import resize_axis

# 'auto' / 'plain' (JAX's 'block' / 'xla'): the fused kernels B1-B3 (B9-B11 in
# training) or their plain versions; 'rowbias' / 'pallas_rp' / 'window' /
# 'pallas': every block's attention through B2b / B14 / B13 / B11 on the
# augmented q, k; 'window_plain': B13's plain version; 'xla_naive': the
# materialised-bias oracle (ops/rel_pos_attention.py _attention).
ATTN_IMPLS = ("auto", "plain", "block", "xla", "rowbias", "pallas_rp", "window",
              "window_plain", "pallas", "xla_naive")


def fused(attn_impl: str) -> bool:
    """Whether ``attn_impl`` runs the fused block kernels (B1, B2, B3) or
    their plain versions, rather than JAX's unfused route."""
    return attn_impl in ("auto", "plain")


# JAX's names of the fused routes: 'block' runs as 'auto' does on its TPU (B1
# in the windowed blocks, the global blocks as 'auto', B3 in every tail);
# 'xla' is its XLA math, the port's plain versions.
ATTN_ALIASES = {"block": "auto", "xla": "plain"}


def resolved(attn_impl: str) -> str:
    """The route an ``attn_impl`` takes (:data:`ATTN_ALIASES`)."""
    return ATTN_ALIASES.get(attn_impl, attn_impl)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm on NHWC maps, eps 1e-6 (reference common.py)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_2d(x, self.weight, self.bias, self.eps)


def window_partition(x: torch.Tensor, window: int):
    """(B, H, W, C) -> (B * nWin, win, win, C), zero-padded; returns the
    windows and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % window, (-w) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, pad_hw, hw):
    """Inverse of :func:`window_partition`."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class Attention(nn.Module):
    """Multi-head attention with decomposed rel-pos bias over an (H, W)
    token grid. Under the fused impls windowed blocks run the whole body
    through ``window_attention_block``; global blocks, and every block
    under 'rowbias' and 'pallas_rp', run the qkv projection as a plain
    matmul (as in JAX) and ``rel_pos_attention_proj``."""

    def __init__(self, dim: int, num_heads: int, input_size: tuple[int, int],
                 windowed: bool, dtype: torch.dtype, attn_impl: str):
        super().__init__()
        self.num_heads = num_heads
        self.windowed = windowed
        self.dtype = dtype
        self.attn_impl = attn_impl
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))

    def weights(self, hw: tuple[int, int]):
        """(wqkv, bqkv, wo, bo, rh, rw): the projections in the working
        dtype with fp32 biases, and the rel-pos tables expanded to the
        (h, w) grid in fp32 — the layouts the kernels take."""
        dt = self.dtype
        return prepared(self, f"weights{hw}", lambda: (
            self.qkv.weight.to(dt), self.qkv.bias.float(), self.proj.weight.to(dt),
            self.proj.bias.float(), *rel_pos_tables(self.rel_pos_h, self.rel_pos_w, hw)),
            *self.parameters())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        block = self.windowed and fused(self.attn_impl)
        if needs_grad(x, *self.parameters()):
            wqkv, bqkv, wo, bo = (self.qkv.weight, self.qkv.bias, self.proj.weight,
                                  self.proj.bias)
            rh, rw = rel_pos_tables(self.rel_pos_h, self.rel_pos_w, (h, w))
            if block:
                out = window_attention_block_train(x.reshape(b, h * w, c), wqkv, bqkv, wo, bo,
                                                   rh, rw, self.num_heads, self.attn_impl)
                return out.reshape(b, h, w, c)
        else:
            wqkv, bqkv, wo, bo, rh, rw = self.weights((h, w))
            if block:
                fn = (window_attention_block if self.attn_impl == "auto"
                      else window_attention_block_plain)
                out = fn(x.reshape(b, h * w, c), wqkv, bqkv, wo, bo, rh, rw, self.num_heads)
                return out.reshape(b, h, w, c)
        qkv = linear(x, wqkv, bqkv, self.dtype)
        qkv = qkv.reshape(b, h * w, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous()
        out = rel_pos_attention_proj(q, k, v, rh, rw, wo, bo, impl=self.attn_impl)
        return out.reshape(b, h, w, c)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    """Pre-norm transformer block, windowed when ``window_size > 0``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window_size: int, input_size: tuple[int, int],
                 dtype: torch.dtype, attn_impl: str):
        super().__init__()
        self.window_size = window_size
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        attn_size = (window_size, window_size) if window_size > 0 else input_size
        self.attn = Attention(dim, num_heads, attn_size, window_size > 0, dtype,
                              attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = layer_norm_f32(x, self.norm1.weight, self.norm1.bias, 1e-6).to(self.dtype)
        if self.window_size > 0:
            # Pad after norm1 and the cast: pad tokens are zeros that still
            # attend, as in the reference.
            y, pad_hw = window_partition(y, self.window_size)
        y = self.attn(y)
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, pad_hw, (h, w))
        x2, y2 = x.reshape(-1, c), y.reshape(-1, c)
        grad = needs_grad(x, y, *self.norm2.parameters(), *self.mlp.parameters())
        if not fused(self.attn_impl):  # JAX's _tail_xla, autograd's backward
            n2, mlp, dt = self.norm2, self.mlp, self.dtype
            weights = (n2.weight, n2.bias, mlp.lin1.weight.to(dt), mlp.lin1.bias.to(dt),
                       mlp.lin2.weight.to(dt), mlp.lin2.bias.to(dt)) if grad \
                else self.tail_weights()
            out = block_tail_plain(x2, y2, *weights)
        elif grad:
            n2, mlp = self.norm2, self.mlp
            out = block_tail_train(x2, y2, n2.weight, n2.bias, mlp.lin1.weight, mlp.lin1.bias,
                                   mlp.lin2.weight, mlp.lin2.bias, self.attn_impl)
        else:
            fn = block_tail if self.attn_impl == "auto" else block_tail_plain
            out = fn(x2, y2, *self.tail_weights())
        return out.reshape(b, h, w, c)

    def tail_weights(self):
        """(scale, bias, w1, b1, w2, b2) as ``block_tail`` takes them: norm2
        fp32, the MLP in the working dtype (``nn.Linear`` layouts)."""
        dt, n2, mlp = self.dtype, self.norm2, self.mlp
        return prepared(self, "tail", lambda: (
            n2.weight.float(), n2.bias.float(), mlp.lin1.weight.to(dt), mlp.lin1.bias.to(dt),
            mlp.lin2.weight.to(dt), mlp.lin2.bias.to(dt)),
            *n2.parameters(), *mlp.parameters())


def _group_norm(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm(1) over (H, W, C) of an NHWC map, in fp32 (flax
    ``GroupNorm(num_groups=1)`` reduces over every non-batch axis, with the
    fast variance). Plain reductions over the whole map: ``F.group_norm``
    gives each (batch, group) row one CUDA block, 27.6 ms for SimpleFPN's 8
    norms at 1024^2 (PERF.md)."""
    return group_norm_f32(x, gn.num_groups, gn.weight, gn.bias, gn.eps)


class SimpleFPN(nn.Module):
    """Four-branch neck: {res2: 1/4, res3: 1/8, res4: 1/16, res5: 1/32} of
    widths ``out_dims`` from the single-scale ViT output. Norms are
    GroupNorm(1, eps 1e-5) over (H, W, C) in fp32; activations are stored
    in the working dtype."""

    def __init__(self, in_dim: int = 768,
                 out_dims: Sequence[int] = (128, 256, 512, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        gn = lambda ch: nn.GroupNorm(1, ch, eps=1e-5)  # noqa: E731
        d4c = max(out_dims[0] * 2, in_dim // 2)
        self.down_4 = nn.Sequential(
            nn.ConvTranspose2d(in_dim, d4c, 2, 2), gn(d4c), nn.GELU(),
            nn.ConvTranspose2d(d4c, d4c // 2, 2, 2), gn(d4c // 2),
            nn.Conv2d(d4c // 2, out_dims[0], 1), gn(out_dims[0]), nn.GELU())
        d8c = max(out_dims[1], in_dim // 2)
        self.down_8 = nn.Sequential(
            nn.ConvTranspose2d(in_dim, d8c, 2, 2), gn(d8c),
            nn.Conv2d(d8c, out_dims[1], 1), gn(out_dims[1]), nn.GELU())
        self.down_16 = nn.Sequential(
            nn.Conv2d(in_dim, out_dims[2], 1), gn(out_dims[2]), nn.GELU())
        d32c = max(out_dims[3], in_dim * 2)
        self.down_32 = nn.Sequential(
            nn.Conv2d(in_dim, d32c, 2, 2), gn(d32c),
            nn.Conv2d(d32c, out_dims[3], 1), gn(out_dims[3]), nn.GELU())

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        dt = self.dtype
        act = lambda t: gelu(t.to(dt))  # noqa: E731
        d4, d8, d16, d32 = self.down_4, self.down_8, self.down_16, self.down_32
        y = act(_group_norm(conv_transpose_nhwc(x, d4[0], dt), d4[1]))
        y = _group_norm(conv_transpose_nhwc(y, d4[3], dt), d4[4])
        res2 = act(_group_norm(conv_nhwc(y, d4[5], dt), d4[6]))
        y = _group_norm(conv_transpose_nhwc(x, d8[0], dt), d8[1])
        res3 = act(_group_norm(conv_nhwc(y, d8[2], dt), d8[3]))
        res4 = act(_group_norm(conv_nhwc(x, d16[0], dt), d16[1]))
        y = _group_norm(conv_nhwc(x, d32[0], dt), d32[1])
        res5 = act(_group_norm(conv_nhwc(y, d32[2], dt), d32[3]))
        return {"res2": res2, "res3": res3, "res4": res4, "res5": res5}


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch, patch)


class ImageEncoderViT(nn.Module):
    """ViT-B/L/H SAM encoder. ``forward`` takes normalised NHWC pixels and
    returns ``(sam_embedding (B, H/16, W/16, out_chans), {res2..res5})``."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, out_chans: int = 256,
                 window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11),
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        attn_impl = resolved(attn_impl)
        self.patch_size = patch_size
        self.dtype = dtype
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  0 if i in global_attn_indexes else window_size,
                  (grid, grid), dtype, attn_impl)
            for i in range(depth))
        self.orig_neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False), LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans))
        self.neck = SimpleFPN(embed_dim, dtype=dtype)

    def _patch_embed(self, x: torch.Tensor) -> torch.Tensor:
        proj = self.patch_embed.proj
        if self.dtype != torch.bfloat16:
            return conv_nhwc(x, proj, self.dtype)
        # A stride-p p x p conv is one per-patch matmul (as the JAX bf16 path).
        b, hh, ww, cin = x.shape
        p = self.patch_size
        gh, gw = hh // p, ww // p
        xp = x.to(self.dtype).reshape(b, gh, p, gw, p, cin)
        xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * cin)
        kernel = proj.weight.permute(2, 3, 1, 0).reshape(p * p * cin, -1)
        y = xp @ kernel.to(self.dtype) + proj.bias.to(self.dtype)
        return y.reshape(b, gh, gw, -1)

    def forward(self, x: torch.Tensor, return_fpn: bool = True,
                return_embedding: bool = True):
        """``return_fpn=False`` skips SimpleFPN, ``return_embedding=False``
        the SAM neck, each returning ``None`` in its place: a JAX program
        that reads only one of them (serving and ``bench.py`` the
        embedding, the seg train step the FPN) never computes the other, as
        XLA drops it as dead code."""
        x = self._patch_embed(x)
        pos = self.pos_embed
        h, w = x.shape[1], x.shape[2]
        if (h, w) != tuple(pos.shape[1:3]):
            pos = resize_axis(resize_axis(pos, 1, h, "cubic"), 2, w, "cubic")
        x = x + pos.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        sam_embedding = None
        if return_embedding:
            y = conv_nhwc(x, self.orig_neck[0], self.dtype)
            y = self.orig_neck[1](y)
            y = conv_nhwc(y, self.orig_neck[2], self.dtype, padding=1)
            sam_embedding = self.orig_neck[3](y)
        return sam_embedding, self.neck(x) if return_fpn else None
