"""One-hot deformable level forward (B15), the per-level sampling of the
``hybrid`` deformable core on its small levels.

Replaces ``iuvl_tpu/ops/pallas/onehot_gather.py``
``onehot_deform_level_forward``. Kernel: ``csrc/onehot_gather.cu``, whose
header says what bounds it on the card and what it keeps of the TPU's
arithmetic. Inputs and output are the JAX function's: the wide map ``v4``
(BH, cells, 4d) bf16 or fp32, the clipped top-left cells ``idx``
(BH, Lq, P) int32, the slot weights ``wslot`` (BH, Lq, 4, P) fp32 with the
attention weight folded in; the output (BH, Lq, d) in v4's dtype:

    out[r] = sum_s rnd(W_s[r]) @ v4[b(r), :, s*d:(s+1)*d],
    W_s[r, cell] = sum_{p: idx[r, p] = cell} wslot[r, s, p]   (fp32),

rnd the rounding to v4's dtype, the products summed in fp32.
"""

from __future__ import annotations

import torch

from .build import launch, require
from .msdeform import check_head_width

# Queries per step of the plain version: its dense (BH, chunk, cells) fp32
# weight matrix is 134 MB at the res5 shape (BH 8, 1024 cells).
PLAIN_CHUNK = 4096
MAX_POINTS = 8


def onehot_deform_level_forward_plain(v4: torch.Tensor, idx: torch.Tensor, wslot: torch.Tensor,
                                      n_points: int) -> torch.Tensor:
    """The TPU kernel's arithmetic in PyTorch: per slot a dense fp32 weight
    matrix over the cells (the points' weights added where they hit),
    rounded to v4's dtype, times the slot's columns with fp32 sums."""
    bh, cells, d4 = v4.shape
    d, lq = d4 // 4, idx.shape[1]
    out = torch.empty((bh, lq, d), dtype=v4.dtype, device=v4.device)
    table = v4.float()
    for start in range(0, lq, PLAIN_CHUNK):
        rows = slice(start, min(lq, start + PLAIN_CHUNK))
        ix = idx[:, rows].long()
        inside = (ix >= 0) & (ix < cells)  # an index outside the table hits no cell
        ix = ix.clamp(0, cells - 1)
        acc = torch.zeros((bh, ix.shape[1], d), dtype=torch.float32, device=v4.device)
        for s in range(4):
            w = torch.zeros((bh, ix.shape[1], cells), dtype=torch.float32, device=v4.device)
            w.scatter_add_(2, ix, wslot[:, rows, s] * inside)
            acc += torch.bmm(w.to(v4.dtype).float(), table[:, :, s * d:(s + 1) * d])
        out[:, rows] = acc.to(v4.dtype)
    return out


def onehot_deform_level_forward(v4: torch.Tensor, idx: torch.Tensor, wslot: torch.Tensor,
                                n_points: int) -> torch.Tensor:
    """B15: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Arguments as :func:`onehot_deform_level_forward_plain`
    (d in ``msdeform.HEAD_WIDTHS``, P <= 8)."""
    if v4.device.type == "cpu":
        return onehot_deform_level_forward_plain(v4, idx, wslot, n_points)
    bh, cells, d4 = v4.shape
    lq = idx.shape[1]
    dev = v4.device
    if v4.dtype not in (torch.bfloat16, torch.float32) or d4 % 4:
        raise ValueError(f"onehot_deform_level_forward: v4 is {v4.dtype} of width {d4}; the "
                         "kernel takes bf16 or fp32 of width 4 x d")
    check_head_width("onehot_deform_level_forward", d4 // 4)
    if not 1 <= n_points <= MAX_POINTS:
        raise ValueError(f"onehot_deform_level_forward: {n_points} points; the kernel takes "
                         f"1 to {MAX_POINTS}")
    require("onehot_deform_level_forward", "v4", v4, v4.dtype, (bh, cells, d4), dev)
    require("onehot_deform_level_forward", "idx", idx, torch.int32, (bh, lq, n_points), dev)
    require("onehot_deform_level_forward", "wslot", wslot, torch.float32,
            (bh, lq, 4, n_points), dev)
    out = torch.empty((bh, lq, d4 // 4), dtype=v4.dtype, device=dev)
    launch("iuvl_onehot_level_fwd", dev, v4.data_ptr(), idx.data_ptr(), wslot.data_ptr(),
           out.data_ptr(), bh, cells, lq, n_points, d4 // 4, int(v4.dtype == torch.bfloat16))
    onehot_deform_level_forward.launches += 1
    return out


onehot_deform_level_forward.launches = 0
