"""Separable resize with ``jax.image.resize`` semantics.

``jax.image.resize`` (half-pixel centres, kernel widened by the scale when
downsampling, weights renormalised over the valid input samples) differs
from ``torch.nn.functional.interpolate`` at the edges and when shrinking,
and its cubic kernel is Keys' with a = -0.5 where torch uses -0.75. The
port needs the JAX numbers, so it builds the same weight matrices.
"""

from __future__ import annotations

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def resize_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out_size, in_size) float32 matrix W with ``resized = W @ x`` along
    one axis, as ``jax.image.resize(..., antialias=True)`` computes it."""
    kernel = _KERNELS[method]
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None])
    weights = kernel(x / kernel_scale)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    weights = np.where(inside[None, :], weights, 0.0)
    return weights.T.astype(np.float32)


def resize_axis(x: torch.Tensor, dim: int, size: int, method: str) -> torch.Tensor:
    """Resize ``x`` along ``dim`` to ``size`` (no-op when already that size)."""
    if x.shape[dim] == size:
        return x
    w = torch.from_numpy(resize_matrix(x.shape[dim], size, method)).to(
        device=x.device, dtype=x.dtype)
    return torch.movedim(torch.tensordot(w, x, dims=([1], [dim])), 0, dim)
