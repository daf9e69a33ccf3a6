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


# The kernel's contrib dtypes and their codes.
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def block_rows(width: int) -> int:
    """The sorted rows a block of the kernel's first pass takes at row width
    W: 16 for each of its lane groups (256 threads over the ceil(W / 8)
    pieces of 8 columns of its first slab of at most 2048), at most 1024."""
    return min(16 * (256 // min(-(-width // 8), 256)), 1024)


def segmented_scatter_add(contrib, idx, n_out: int, block: int = 512, chunk: int = 1024):
    """Segmented scatter-add: on CUDA tensors the rows sorted by destination
    (``torch.argsort``, stable), then the CUDA kernel's two passes over
    pieces of the sorted order write every output row once, each sum in one
    fixed order (contrib bf16, fp16 or fp32 of any width W >= 1, summed in
    fp32; idx int32 in [0, n_out)); the plain version on CPU tensors. Raises
    for what JAX's function does not take either (contrib not a float
    type). Arguments and result as :func:`segmented_scatter_add_plain`."""
    if contrib.device.type == "cpu":
        return segmented_scatter_add_plain(contrib, idx, n_out, block, chunk)
    assert n_out % block == 0, (n_out, block)
    rows, width = contrib.shape
    if contrib.dtype not in DTYPES:
        raise ValueError(f"segmented_scatter_add kernel: contrib dtype {contrib.dtype} (needs "
                         "bf16, fp16 or fp32)")
    dev = contrib.device
    require("segmented_scatter_add", "contrib", contrib, contrib.dtype, (rows, width), dev)
    require("segmented_scatter_add", "idx", idx, torch.int32, (rows,), dev)
    order = torch.argsort(idx, stable=True)
    rows_a = block_rows(width)
    blocks = -(-rows // rows_a)  # the scratch: two partial rows and two ints a block
    out = torch.empty((n_out, width), dtype=torch.float32, device=dev)
    scratch = torch.empty((blocks * (2 * (-(-width // 8) * 8) + 2),), dtype=torch.float32,
                          device=dev)
    launch("iuvl_seg_scatter", dev, contrib.data_ptr(), idx.data_ptr(), order.data_ptr(),
           out.data_ptr(), scratch.data_ptr(), rows, n_out, width, rows_a,
           DTYPES[contrib.dtype])
    segmented_scatter_add.launches += 1
    return out


segmented_scatter_add.launches = 0
