"""Small shared tensor functions with the JAX package's rounding points.

Parameters stay fp32 (as flax keeps them) and are cast to the working
dtype where they are used, as flax's ``dtype=`` modules do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``: the switch between
    the training routes (kernels with backward kernels, weight layouts made
    inside the graph) and the serving routes (cached layouts)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def prepared(owner: torch.nn.Module, name: str, make, *params: torch.Tensor):
    """``make()``, computed once per state of ``params`` and kept on
    ``owner``: the weight layouts the kernels take (casts, transposes,
    expanded tables) are made when the weights change, not at every call.
    Made under ``no_grad``, so they carry no gradient: a caller that trains
    (:func:`needs_grad`) builds its layouts inside the graph instead.
    The key is each parameter's storage, dtype and in-place version, so
    ``load_state_dict`` and ``.to()`` make them anew. (Tensors made under
    ``torch.inference_mode`` have no version: weights of a model built
    there and then changed in place there are not seen.)"""
    key = tuple((p.data_ptr(), p.device, p.dtype, None if p.is_inference() else p._version)
                for p in params)
    cache = owner.__dict__.setdefault("_prepared", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = cache[name] = (key, make())
    return hit[1]


def plain_vjp(plain, saved, needs, g, *static):
    """The cotangents of ``plain(*saved, *static)`` for cotangent ``g``,
    recomputed under autograd: one per saved input, None where ``needs``
    is False: the backward of the kernels that have no backward kernel of
    their own (B4-B6), as JAX's custom VJPs take ``jax.vjp`` of the XLA
    oracle there."""
    inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
    wanted = [t for t in inputs if t.requires_grad]
    if not wanted:
        return [None] * len(saved)
    with torch.enable_grad():
        out = plain(*inputs, *static)
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
    return [next(grads) if n else None for n in needs]


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with ``jnp.take``'s semantics: a negative id counts
    from the end of the table, and an id outside it gives a row of NaN
    (no device assert). The rows carry ``table``'s gradient."""
    v = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + v, ids)
    inside = (ids >= 0) & (ids < v)
    rows = table[ids.clamp(0, v - 1)]
    return torch.where(inside[..., None], rows,
                       torch.full((), float("nan"), dtype=rows.dtype, device=rows.device))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in fp32, tanh approximation in bf16
    (``iuvl_tpu/models/sam/image_encoder.py`` ``gelu``)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           dtype: torch.dtype) -> torch.Tensor:
    """``x @ weight^T + bias`` in ``dtype``: the product is rounded to the
    dtype before the bias is added, as flax ``nn.Dense(dtype=...)`` does."""
    y = x.to(dtype) @ weight.to(dtype).t()
    return y if bias is None else y + bias.to(dtype)


def layer_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)`` over the last axis: fp32 stats
    with the fast variance ``max(E[x^2] - E[x]^2, 0)``; returns fp32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    return (xf - mu) * mul + bias.float()


def group_norm_f32(x: torch.Tensor, groups: int, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """flax ``nn.GroupNorm(dtype=float32)`` on NHWC: fp32 statistics over
    (H, W, C / groups) with the fast variance; returns fp32."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mu = xf.mean((1, 3), keepdim=True)
    var = torch.clamp((xf * xf).mean((1, 3), keepdim=True) - mu * mu, min=0.0)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * scale.float() + bias.float()


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """SAM ``LayerNorm2d`` on NHWC: fp32 two-pass stats over channels, the
    result cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def conv_nhwc(x: torch.Tensor, conv: torch.nn.Conv2d, dtype: torch.dtype,
              padding: int = 0) -> torch.Tensor:
    """``conv`` (PyTorch weight layout) on an NHWC tensor, in ``dtype``."""
    b = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype), b,
                 stride=conv.stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose_nhwc(x: torch.Tensor, conv: torch.nn.ConvTranspose2d,
                        dtype: torch.dtype) -> torch.Tensor:
    """2x2 / stride-2 transposed conv on NHWC, in ``dtype``."""
    b = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv_transpose2d(x.to(dtype).permute(0, 3, 1, 2),
                           conv.weight.to(dtype), b, stride=conv.stride)
    return y.permute(0, 2, 3, 1)
