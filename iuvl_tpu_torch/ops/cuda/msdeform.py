"""Multi-scale deformable attention per level (B7): the forward, and the
tap-row gather and d_value scatter of the backward.

Replaces the flat core of ``iuvl_tpu/ops/msdeform.py`` (``_flat_level``,
``:468-680``): ``_flat_level_fwd_impl``, and in ``_flat_level_bwd`` the
gather ``_flat_gather_rows(_wide_map(v)[i], base + idx)`` and the dv4
scatter with its inverse-roll fold. Kernels: ``csrc/msdeform.cu``, whose
header says what bounds them on the card.

Layouts are JAX's: a level's values ``(B, nh, hw, d)``, the pixel
coordinates ``x``, ``y`` and attention weights ``(B, nh, Lq, P)`` fp32, the
top-left indices ``idx`` of one image ``(nh, Lq, P)`` int32 (without the head
base), tap rows ``(R, 4d)`` with R = nh * Lq * P. A point's four taps are the
rows ``(idx + off) mod hw`` of its head's map, ``off`` in :func:`tap_offsets`:
the rows that ``_wide_map``'s rolls line up, their wrap included (a slot that
wraps carries weight 0).
"""

from __future__ import annotations

import torch

from .build import launch, require

VALUE_DTYPES = (torch.bfloat16, torch.float32)


def tap_offsets(w: int) -> tuple[int, int, int, int]:
    """Row offsets of the four slots from the top-left tap: (0, 1, w, w + 1)."""
    return (0, 1, w, w + 1)


def _tap_rows(idx: torch.Tensor, hw: int, w: int) -> list[torch.Tensor]:
    """Per slot, the flat (head base + row) index of every tap, (R,) int64."""
    nh = idx.shape[0]
    base = torch.arange(nh, device=idx.device).view(nh, *([1] * (idx.dim() - 1))) * hw
    return [(base + (idx.long() + off) % hw).reshape(-1) for off in tap_offsets(w)]


def deform_gather_rows_plain(v: torch.Tensor, idx: torch.Tensor, w: int) -> torch.Tensor:
    """One image's tap rows: v (nh, hw, d), idx (nh, Lq, P) -> (R, 4d) in
    v's dtype, ``_flat_gather_rows(_wide_map(v), base + idx)``."""
    nh, hw, d = v.shape
    table = v.reshape(nh * hw, d)
    return torch.cat([table[rows] for rows in _tap_rows(idx, hw, w)], dim=-1)


def deform_scatter_dv_plain(contrib: torch.Tensor, idx: torch.Tensor, hw: int,
                            w: int) -> torch.Tensor:
    """One image's d_value: each slot plane of contrib (R, 4d) added at its
    tap rows, in fp32 -> (nh, hw, d): JAX's dv4 scatter and inverse-roll
    fold."""
    nh = idx.shape[0]
    d = contrib.shape[1] // 4
    dv = torch.zeros((nh * hw, d), dtype=torch.float32, device=contrib.device)
    for k, rows in enumerate(_tap_rows(idx, hw, w)):
        dv.index_add_(0, rows, contrib[:, k * d:(k + 1) * d].float())
    return dv.view(nh, hw, d)


def ms_deform_level_fwd_plain(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                              aw: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """One level's contribution, the value of ``_flat_level_fwd_impl``:
    v (B, nh, h*w, d); x, y, aw (B, nh, Lq, P) -> (B, nh, Lq, d) fp32, the
    slot weights in fp32 with the attention weight folded in."""
    from ..msdeform import wide_idx_wslot  # here: ops/msdeform.py imports this module

    b, nh, hw, d = v.shape
    lq, p = x.shape[2], x.shape[3]
    idx, wslot = wide_idx_wslot(h, w, x, y)
    wa = wslot * aw.float()[..., None]                        # (B, nh, Lq, P, 4)
    outs = []
    for i in range(b):
        g4 = deform_gather_rows_plain(v[i], idx[i], w).float().view(nh, lq, p, 4, d)
        outs.append((g4 * wa[i][..., None]).sum((2, 3)))
    return torch.stack(outs)


def _check_values(kernel: str, name: str, t: torch.Tensor, width: int = 64) -> None:
    if t.dtype not in VALUE_DTYPES or t.shape[-1] != width:
        raise ValueError(f"{kernel}: {name} is {t.dtype} of width {t.shape[-1]}; the kernel "
                         f"takes {VALUE_DTYPES} of width {width}")


def ms_deform_level_fwd(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor, aw: torch.Tensor,
                        h: int, w: int) -> torch.Tensor:
    """B7 forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments as :func:`ms_deform_level_fwd_plain` (d = 64)."""
    if v.device.type == "cpu":
        return ms_deform_level_fwd_plain(v, x, y, aw, h, w)
    b, nh, hw, d = v.shape
    lq, p = x.shape[2], x.shape[3]
    dev = v.device
    _check_values("ms_deform_level_fwd", "v", v)
    require("ms_deform_level_fwd", "v", v, v.dtype, (b, nh, h * w, d), dev)
    for name, t in (("x", x), ("y", y), ("aw", aw)):
        require("ms_deform_level_fwd", name, t, torch.float32, (b, nh, lq, p), dev)
    out = torch.empty((b, nh, lq, d), dtype=torch.float32, device=dev)
    launch("iuvl_msdeform_fwd", dev, v.data_ptr(), x.data_ptr(), y.data_ptr(), aw.data_ptr(),
           out.data_ptr(), b, nh, lq, p, h, w, int(v.dtype == torch.bfloat16))
    ms_deform_level_fwd.launches += 1
    return out


def deform_gather_rows(v: torch.Tensor, idx: torch.Tensor, w: int) -> torch.Tensor:
    """B7 gather: the CUDA kernel for CUDA tensors (idx int32), the plain
    version for CPU tensors. Arguments as :func:`deform_gather_rows_plain`."""
    if v.device.type == "cpu":
        return deform_gather_rows_plain(v, idx, w)
    nh, hw, d = v.shape
    dev = v.device
    _check_values("deform_gather_rows", "v", v)
    require("deform_gather_rows", "v", v, v.dtype, (nh, hw, d), dev)
    require("deform_gather_rows", "idx", idx, torch.int32, (nh, *idx.shape[1:]), dev)
    per_head = idx[0].numel()
    g4 = torch.empty((nh * per_head, 4 * d), dtype=v.dtype, device=dev)
    launch("iuvl_deform_gather", dev, v.data_ptr(), idx.data_ptr(), g4.data_ptr(), nh, per_head,
           hw, w, int(v.dtype == torch.bfloat16))
    deform_gather_rows.launches += 1
    return g4


def deform_scatter_dv(contrib: torch.Tensor, idx: torch.Tensor, hw: int, w: int) -> torch.Tensor:
    """B7 scatter: the CUDA kernel for CUDA tensors (idx int32), the plain
    version for CPU tensors. Arguments as :func:`deform_scatter_dv_plain`."""
    if contrib.device.type == "cpu":
        return deform_scatter_dv_plain(contrib, idx, hw, w)
    nh = idx.shape[0]
    per_head = idx[0].numel()
    dev = contrib.device
    _check_values("deform_scatter_dv", "contrib", contrib, 256)
    require("deform_scatter_dv", "contrib", contrib, contrib.dtype, (nh * per_head, 256), dev)
    require("deform_scatter_dv", "idx", idx, torch.int32, (nh, *idx.shape[1:]), dev)
    dv = torch.zeros((nh, hw, 64), dtype=torch.float32, device=dev)
    launch("iuvl_deform_scatter", dev, contrib.data_ptr(), idx.data_ptr(), dv.data_ptr(), nh,
           per_head, hw, w, int(contrib.dtype == torch.bfloat16))
    deform_scatter_dv.launches += 1
    return dv


ms_deform_level_fwd.launches = 0
deform_gather_rows.launches = 0
deform_scatter_dv.launches = 0
