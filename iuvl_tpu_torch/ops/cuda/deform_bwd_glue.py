"""Cotangent glue of the deformable backward (B8).

Replaces ``iuvl_tpu/ops/pallas/deform_bwd_glue.py``: ``deform_bwd_glue_q``
(the query-row layout, the one ``_flat_level_bwd`` runs) and
``deform_bwd_glue`` (the row layout), each with JAX's contract. Kernels:
``csrc/deform_bwd_glue.cu``, whose header says what bounds them on the card;
the two give identical results.
"""

from __future__ import annotations

import torch

from .build import launch, require
from .msdeform import check_head_width


def deform_bwd_glue_plain(g4: torch.Tensor, gout: torch.Tensor, wa: torch.Tensor, p: int):
    """g4 (R, 4d) tap rows; gout (Q, d) output cotangent, R = Q * p; wa
    (R, 4) fp32 folded slot weights. Returns (contrib (R, 4d) = wa times the
    tiled cotangent, in g4's dtype; dots (R, 4) fp32, each slot's row dotted
    with the cotangent)."""
    r, fourd = g4.shape
    d = fourd // 4
    q = gout.shape[0]
    assert q * p == r, (q, p, r)
    go = gout.float().view(q, 1, 1, d)
    dots = (g4.float().view(q, p, 4, d) * go).sum(-1).view(r, 4)
    contrib = (wa.float().view(q, p, 4, 1) * go).to(g4.dtype).view(r, fourd)
    return contrib, dots


def _glue(entry: str, g4, gout, wa, p: int):
    r, fourd = g4.shape
    q = gout.shape[0]
    dev = g4.device
    if g4.dtype not in (torch.bfloat16, torch.float32) or fourd % 4:
        raise ValueError(f"{entry}: g4 is {g4.dtype} of width {fourd}; the kernel takes "
                         "bf16 or fp32 of width 4 x d")
    check_head_width(entry, fourd // 4)
    if q * p != r:
        raise ValueError(f"{entry}: {r} rows are not {q} queries x {p} points")
    require(entry, "g4", g4, g4.dtype, (r, fourd), dev)
    require(entry, "gout", gout, torch.float32, (q, fourd // 4), dev)
    require(entry, "wa", wa, torch.float32, (r, 4), dev)
    contrib = torch.empty_like(g4)
    dots = torch.empty((r, 4), dtype=torch.float32, device=dev)
    launch("iuvl_" + entry, dev, g4.data_ptr(), gout.data_ptr(), wa.data_ptr(),
           contrib.data_ptr(), dots.data_ptr(), q, p, fourd // 4,
           int(g4.dtype == torch.bfloat16))
    return contrib, dots


def deform_bwd_glue_q(g4: torch.Tensor, gout: torch.Tensor, wa: torch.Tensor, p: int):
    """B8, query-row layout: the CUDA kernel for CUDA tensors (d in
    ``msdeform.HEAD_WIDTHS``, gout fp32), the plain version for CPU tensors.
    Arguments and results as :func:`deform_bwd_glue_plain`."""
    if g4.device.type == "cpu":
        return deform_bwd_glue_plain(g4, gout, wa, p)
    out = _glue("deform_bwd_glue_q", g4, gout, wa, p)
    deform_bwd_glue_q.launches += 1
    return out


def deform_bwd_glue(g4: torch.Tensor, gout: torch.Tensor, wa: torch.Tensor, p: int):
    """B8, row layout: as :func:`deform_bwd_glue_q`."""
    if g4.device.type == "cpu":
        return deform_bwd_glue_plain(g4, gout, wa, p)
    out = _glue("deform_bwd_glue", g4, gout, wa, p)
    deform_bwd_glue.launches += 1
    return out


deform_bwd_glue_q.launches = 0
deform_bwd_glue.launches = 0
