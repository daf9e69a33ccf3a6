"""Small shared tensor functions with the JAX package's rounding points.

Parameters stay fp32 (as flax keeps them) and are cast to the working
dtype where they are used, as flax's ``dtype=`` modules do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def prepared(owner: torch.nn.Module, name: str, make, *params: torch.Tensor):
    """``make()``, computed once per state of ``params`` and kept on
    ``owner``: the weight layouts the kernels take (casts, transposes,
    expanded tables) are made when the weights change, not at every call.
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
