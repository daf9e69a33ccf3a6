"""Multi-scale deformable attention per level (B7): the forward, and the
tap-row gather and d_value scatter of the backward.

Replaces the flat core of ``iuvl_tpu/ops/msdeform.py`` (``_flat_level``,
``:468-680``): ``_flat_level_fwd_impl``, and in ``_flat_level_bwd`` the
gather ``_flat_gather_rows(_wide_map(v)[i], base + idx)`` and the dv4
scatter with its inverse-roll fold. Kernels: ``csrc/msdeform.cu``, whose
header says what bounds them on the card.

The scatter sums each cell's rows in a fixed order (no atomics): the rows
bucketed by (head, top-left cell), stably, each bucket summed in row order,
a bucket of more than :data:`SCATTER_CHUNK` rows in pieces cut where the
sorted order's ``SCATTER_CHUNK``-row pieces begin, the pieces' sums added
in order, then JAX's fold. Its plain version sums in that same order.

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
# The head widths d = syslearner_dim / nheads that the deformable kernels
# (B7, B8, B15) take: 16-byte bf16 pieces of 8 channels, B15's 16-channel
# groups, and B8's cotangent in registers, 16 values a lane at most.
HEAD_WIDTHS = range(16, 129, 16)
# The scatter kernel's rows a sort block, most bits a radix pass, and rows
# a piece of a long bucket (csrc/msdeform.cu kSortTile, kMaxDigitBits,
# kChunk).
SCATTER_TILE, SCATTER_DIGIT_BITS, SCATTER_CHUNK = 2048, 9, 256


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


def scatter_plan(buckets: int) -> tuple[int, int]:
    """The scatter kernel's radix sort of the keys head * hw + cell in
    [0, buckets): (bits a pass, passes), passes of at most
    SCATTER_DIGIT_BITS bits, as even as they come."""
    bits = max(1, (buckets - 1).bit_length())
    passes = -(-bits // SCATTER_DIGIT_BITS)
    return -(-bits // passes), passes


def scatter_buckets_plain(idx: torch.Tensor, hw: int):
    """The scatter's buckets: the keys head * hw + top-left cell of the rows
    (R,) (head-major, R = nh * Lq * P), the rows sorted stably by key (R,)
    and each bucket's first position in that order (nh * hw + 1,), int64."""
    nh = idx.shape[0]
    keys = (torch.arange(nh, device=idx.device)[:, None] * hw
            + idx.reshape(nh, -1).long()).reshape(-1)
    start = torch.zeros(nh * hw + 1, dtype=torch.long, device=idx.device)
    start[1:] = torch.cumsum(torch.bincount(keys, minlength=nh * hw), 0)
    return keys, torch.argsort(keys, stable=True), start


def _sums_in_order(rows: torch.Tensor, first: torch.Tensor, count: torch.Tensor,
                   out: int) -> torch.Tensor:
    """Each segment's rows summed in order in fp32: segment i is rows[first[i]
    + k] for k < count[i], added k by k from zero -> (out, width)."""
    sums = torch.zeros((out, rows.shape[1]), dtype=torch.float32, device=rows.device)
    for k in range(int(count.max()) if count.numel() else 0):
        act = torch.nonzero(count > k).squeeze(1)
        sums[act] += rows[first[act] + k].float()
    return sums


def deform_scatter_dv_plain(contrib: torch.Tensor, idx: torch.Tensor, hw: int,
                            w: int) -> torch.Tensor:
    """One image's d_value: each slot plane of contrib (R, 4d) added at its
    tap rows, in fp32 -> (nh, hw, d): JAX's dv4 scatter and inverse-roll
    fold, each cell's sums in the kernel's order (the module's docstring)."""
    nh = idx.shape[0]
    d = contrib.shape[1] // 4
    keys, order, start = scatter_buckets_plain(idx, hw)
    key_at = keys[order]
    pos = torch.arange(order.numel(), device=idx.device)
    long_bucket = (start[1:] - start[:-1])[key_at] > SCATTER_CHUNK
    new = (pos == start[key_at]) | (long_bucket & (pos % SCATTER_CHUNK == 0))
    first = pos[new]
    count = torch.diff(first, append=first.new_tensor([order.numel()]))
    pieces = _sums_in_order(contrib[order], first, count, first.numel())
    per_bucket = torch.bincount(key_at[first], minlength=nh * hw)
    s = _sums_in_order(pieces, torch.cumsum(per_bucket, 0) - per_bucket, per_bucket, nh * hw)
    s = s.view(nh, hw, 4, d)
    dv = s[:, :, 0]
    for k, off in enumerate(tap_offsets(w)[1:], start=1):
        dv = dv + torch.roll(s[:, :, k], off, dims=1)
    return dv


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


def check_head_width(kernel: str, d: int) -> None:
    """Raise ValueError unless the deformable kernels take head width ``d``
    (:data:`HEAD_WIDTHS`: a multiple of 16 from 16 to 128)."""
    if d not in HEAD_WIDTHS:
        raise ValueError(f"{kernel}: head width {d}; the kernel takes multiples of 16 from "
                         f"{HEAD_WIDTHS.start} to {HEAD_WIDTHS.stop - 1}")


def _check_values(kernel: str, name: str, t: torch.Tensor, slots: int = 1) -> int:
    """The head width of ``t``, rows of ``slots`` head-width slots, after
    checking its dtype and width."""
    width = t.shape[-1]
    if t.dtype not in VALUE_DTYPES or width % slots:
        raise ValueError(f"{kernel}: {name} is {t.dtype} of width {width}; the kernel takes "
                         f"{VALUE_DTYPES} of width {slots} x d")
    check_head_width(kernel, width // slots)
    return width // slots


def ms_deform_level_fwd(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor, aw: torch.Tensor,
                        h: int, w: int) -> torch.Tensor:
    """B7 forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments as :func:`ms_deform_level_fwd_plain` (d in
    :data:`HEAD_WIDTHS`)."""
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
           out.data_ptr(), b, nh, lq, p, h, w, d, int(v.dtype == torch.bfloat16))
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
           hw, w, d, int(v.dtype == torch.bfloat16))
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
    d = _check_values("deform_scatter_dv", "contrib", contrib, 4)
    require("deform_scatter_dv", "contrib", contrib, contrib.dtype, (nh * per_head, 4 * d), dev)
    require("deform_scatter_dv", "idx", idx, torch.int32, (nh, *idx.shape[1:]), dev)
    rows = nh * per_head
    digit_bits, passes = scatter_plan(nh * hw)
    i32 = torch.int32
    tiles = -(-rows // SCATTER_TILE)
    ws = torch.empty(4 * rows + (tiles + 1) * (1 << digit_bits), dtype=i32, device=dev)
    start = torch.empty(nh * hw + 1, dtype=i32, device=dev)
    part = torch.empty(-(-rows // SCATTER_CHUNK) * 2 * 4 * d, dtype=torch.float32, device=dev)
    dv = torch.empty((nh, hw, d), dtype=torch.float32, device=dev)
    launch("iuvl_deform_scatter", dev, contrib.data_ptr(), idx.data_ptr(), dv.data_ptr(),
           ws.data_ptr(), start.data_ptr(), part.data_ptr(), nh, per_head, hw, w, d, digit_bits,
           passes, int(contrib.dtype == torch.bfloat16))
    deform_scatter_dv.launches += 1
    return dv


ms_deform_level_fwd.launches = 0
deform_gather_rows.launches = 0
deform_scatter_dv.launches = 0
