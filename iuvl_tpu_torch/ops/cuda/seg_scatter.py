"""Segmented scatter-add: ``zeros((n_out, W), f32).at[idx].add(contrib)``.

Replaces ``iuvl_tpu/ops/pallas/seg_scatter.py:segmented_scatter_add``
(B17), which no function of the JAX package calls; the port keeps it as
its own entry, with JAX's signature. Kernel: ``csrc/seg_scatter.cu``, whose
header says what bounds it on the card and why the TPU's one-hot matmuls
became a segmented sum over pieces of the destination-sorted order.
"""

from __future__ import annotations

import torch

from .build import launch, require


def segmented_scatter_add_plain(contrib, idx, n_out: int, block: int = 512,
                                chunk: int = 1024):
    """The rows of ``contrib`` (R, W) summed in fp32 into rows ``idx`` (R,)
    of a zeroed (n_out, W) fp32 table (``index_put_`` with accumulation).
    ``block`` and ``chunk`` are the TPU kernel's tiling: ``n_out`` must be
    a multiple of ``block``, as JAX asserts; ``chunk`` is not used."""
    del chunk
    assert n_out % block == 0, (n_out, block)
    out = torch.zeros((n_out, contrib.shape[1]), dtype=torch.float32, device=contrib.device)
    return out.index_put_((idx.long(),), contrib.float(), accumulate=True)


def block_rows(width: int) -> int:
    """The sorted rows a block of the kernel's first pass takes at row width
    W: 16 for each of its 256 / (W / 8) lane groups, at most 1024."""
    return min(16 * (256 // (width // 8)), 1024)


def segmented_scatter_add(contrib, idx, n_out: int, block: int = 512, chunk: int = 1024):
    """Segmented scatter-add: on CUDA tensors the rows sorted by destination
    (``torch.argsort``, stable), then the CUDA kernel's two passes over
    pieces of the sorted order write every output row once (contrib bf16,
    W % 8 == 0 and W / 8 dividing 256, idx int32 in [0, n_out)); the plain
    version on CPU tensors. Arguments and result as
    :func:`segmented_scatter_add_plain`."""
    if contrib.device.type == "cpu":
        return segmented_scatter_add_plain(contrib, idx, n_out, block, chunk)
    assert n_out % block == 0, (n_out, block)
    rows, width = contrib.shape
    if width < 8 or width % 8 or 256 % (width // 8):
        raise ValueError(f"segmented_scatter_add kernel: unsupported W={width} (needs "
                         "W % 8 == 0 and W / 8 dividing 256)")
    dev = contrib.device
    require("segmented_scatter_add", "contrib", contrib, torch.bfloat16, (rows, width), dev)
    require("segmented_scatter_add", "idx", idx, torch.int32, (rows,), dev)
    order = torch.argsort(idx, stable=True)
    rows_a = block_rows(width)
    blocks = -(-rows // rows_a)  # the scratch: two partial rows and two ints a block
    out = torch.empty((n_out, width), dtype=torch.float32, device=dev)
    scratch = torch.empty((blocks * (2 * width + 2),), dtype=torch.float32, device=dev)
    launch("iuvl_seg_scatter", dev, contrib.data_ptr(), idx.data_ptr(), order.data_ptr(),
           out.data_ptr(), scratch.data_ptr(), rows, n_out, width, rows_a)
    segmented_scatter_add.launches += 1
    return out


segmented_scatter_add.launches = 0
