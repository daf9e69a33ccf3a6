"""Tap-row scatter-add of the point-sample backward.

Replaces ``iuvl_tpu/ops/pallas/tap_scatter.py:tap_scatter`` (B12). Kernel:
``csrc/tap_scatter.cu``, whose header says what bounds it on the card and
how one launch writes the whole table, each cell's rows summed in row
order.
"""

from __future__ import annotations

import torch

from .build import launch, require


def tap_scatter_plain(base, rows, span: int):
    """``acc[n, base[n, p], :] += rows[n, p, :]`` into a zeroed
    (N, span, L) fp32 table: base (N, P) int32 in [0, span), rows (N, P, L)
    fp32 (the four bilinear taps, L = 4)."""
    n, p = base.shape
    lanes = rows.shape[-1]
    flat = (base.long() + torch.arange(n, device=base.device)[:, None] * span).reshape(-1)
    acc = torch.zeros((n * span, lanes), dtype=torch.float32, device=rows.device)
    acc.index_put_((flat,), rows.reshape(-1, lanes).float(), accumulate=True)
    return acc.reshape(n, span, lanes)


def tap_scatter(base, rows, span: int):
    """Tap scatter: the CUDA kernel for CUDA tensors (int32 base, fp32 rows
    of 4 lanes; one launch writes every cell, two launches the same bits),
    the plain version for CPU tensors. Arguments as
    :func:`tap_scatter_plain`."""
    if base.device.type == "cpu":
        return tap_scatter_plain(base, rows, span)
    n, p = base.shape
    dev = base.device
    require("tap_scatter", "base", base, torch.int32, (n, p), dev)
    require("tap_scatter", "rows", rows, torch.float32, (n, p, 4), dev)
    acc = torch.empty((n, span, 4), dtype=torch.float32, device=dev)
    launch("iuvl_tap_scatter", dev, base.data_ptr(), rows.data_ptr(), acc.data_ptr(), n, p,
           span)
    tap_scatter.launches += 1
    return acc


tap_scatter.launches = 0
