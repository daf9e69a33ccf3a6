"""Automatic mask generation (SAM's "segment everything"), the port's copy
of ``iuvl_tpu/inference/amg.py``.

Point grids, the stability score, the COCO RLE codecs, boxes, crop boxes,
mask NMS and the pipeline: encode once per crop, decode the layer's point
grid in prompt batches through ``Sam.decode_from_embedding`` or
``SysLearner.decode_prompts`` (with ``twoway_impl='chunk'``, one B16 launch
a batch), filter by predicted IoU
and stability, NMS over all crops. Host code is numpy, as in JAX; NMS
computes the pairwise intersection counts as one 0/1 product on a torch
device (exact in fp32 up to 2^24 pixels) and keeps JAX's greedy order,
so the kept set is JAX's. The JAX package's native C++ core is not
imported: its RLE encoder and NMS give the same results as the numpy
paths here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..data.transforms import resize_longest_side


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) normalized [0,1] xy grid at cell centers."""
    offset = 1.0 / (2 * n_per_side)
    pts = np.linspace(offset, 1.0 - offset, n_per_side)
    gx, gy = np.meshgrid(pts, pts)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> list[np.ndarray]:
    """One grid per crop layer, scaled down per layer."""
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def stability_score(mask_logits: np.ndarray, threshold_offset: float = 1.0) -> np.ndarray:
    """IoU between masks thresholded at +-offset around 0. mask_logits (N, H, W)."""
    hi = (mask_logits > threshold_offset).reshape(len(mask_logits), -1).sum(-1)
    lo = (mask_logits > -threshold_offset).reshape(len(mask_logits), -1).sum(-1)
    return hi / np.maximum(lo, 1)


def mask_to_rle(mask: np.ndarray) -> dict:
    """Uncompressed COCO RLE (column-major, runs starting with the zeros)."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [len(flat)]])
    counts = np.diff(idx).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: dict) -> np.ndarray:
    """Inverse of :func:`mask_to_rle`."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    vals = np.zeros(len(counts), bool)
    vals[1::2] = True
    return np.repeat(vals, counts).reshape(w, h).T


def coco_encode_rle(rle: dict) -> dict:
    """Compressed COCO RLE string: each count as its difference from the
    count two back, in 5-bit groups with a continuation bit, chars offset
    by 48 (the pycocotools format)."""
    counts = rle["counts"]
    out = []
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c5 = x & 0x1F
            x >>= 5
            more = (x != -1) if (c5 & 0x10) else (x != 0)
            if more:
                c5 |= 0x20
            out.append(chr(c5 + 48))
    return {"size": list(rle["size"]), "counts": "".join(out)}


def coco_decode_rle(rle: dict) -> dict:
    """Inverse of :func:`coco_encode_rle` -> uncompressed counts."""
    s = rle["counts"]
    counts: list[int] = []
    p = 0
    while p < len(s):
        x = k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return {"size": list(rle["size"]), "counts": counts}


def area_from_rle(rle: dict) -> int:
    return int(sum(rle["counts"][1::2]))


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """XYXY boxes around (N, H, W) bool masks: inclusive max-index edges,
    zeros for empty masks."""
    n = len(masks)
    boxes = np.zeros((n, 4), np.float32)
    if n == 0:
        return boxes
    rows, cols = masks.any(2), masks.any(1)
    nonempty = rows.any(1)
    h, w = masks.shape[1:]
    y0, y1 = rows.argmax(1), h - 1 - rows[:, ::-1].argmax(1)
    x0, x1 = cols.argmax(1), w - 1 - cols[:, ::-1].argmax(1)
    boxes[nonempty] = np.stack([x0, y0, x1, y1], -1)[nonempty].astype(np.float32)
    return boxes


def box_xyxy_to_xywh(box):
    x0, y0, x1, y1 = box
    return [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]


def masks_to_rles(masks: np.ndarray) -> list[dict]:
    return [mask_to_rle(m) for m in masks]


def generate_crop_boxes(im_size: tuple[int, int], n_layers: int,
                        overlap_ratio: float = 512 / 1500):
    """Layer 0 the full image; layer i (2^i)^2 overlapping crops. Returns
    (boxes xyxy, layer indices)."""
    h, w = im_size
    boxes, layers = [[0, 0, w, h]], [0]
    short = min(h, w)
    for layer in range(1, n_layers + 1):
        n = 2 ** layer
        overlap = int(overlap_ratio * short * (2 / n))
        cw = int(math.ceil((overlap * (n - 1) + w) / n))
        ch = int(math.ceil((overlap * (n - 1) + h) / n))
        xs = [int((cw - overlap) * i) for i in range(n)]
        ys = [int((ch - overlap) * i) for i in range(n)]
        for y0 in ys:
            for x0 in xs:
                boxes.append([x0, y0, min(x0 + cw, w), min(y0 + ch, h)])
                layers.append(layer)
    return boxes, layers


def mask_nms(masks: np.ndarray, scores: np.ndarray, iou_thresh: float = 0.7,
             device="cpu") -> np.ndarray:
    """Greedy mask NMS by score, in JAX's order (``np.argsort(-scores)``).
    masks (N, H, W) bool. The pairwise intersections are one 0/1 product on
    ``device`` with fp32 sums (exact: H W < 2^24); a mask of area 0 is
    never kept; a kept mask suppresses every other whose IoU exceeds the
    threshold. Returns the kept indices."""
    n = len(masks)
    order = np.argsort(-scores)
    if n == 0:
        return np.zeros(0, np.int64)
    flat = torch.from_numpy(np.ascontiguousarray(masks).reshape(n, -1)).to(device).float()
    if flat.shape[1] >= 2 ** 24:
        raise ValueError(f"mask_nms: {flat.shape[1]} pixels a mask, over fp32's exact counts")
    inter = (flat @ flat.t()).cpu().numpy().astype(np.int64)
    areas = np.diagonal(inter).copy()
    kept: list[int] = []
    suppressed = np.zeros(n, bool)
    for i in order:
        if suppressed[i] or areas[i] == 0:
            continue
        kept.append(int(i))
        union = areas[i] + areas - inter[i]
        iou = inter[i] / np.maximum(union, 1)
        suppressed |= iou > iou_thresh
        suppressed[i] = True
    return np.asarray(kept, np.int64)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _decode_grid(model, image, grid, batch, pred_iou_thresh, stability_thresh):
    """Encode one (1, S, S, 3) image (raw pixels, numpy), decode the point
    grid in prompt batches of ``batch`` (the last one padded), filter by
    predicted IoU and stability. ``model`` is a ``Sam`` (its
    ``decode_from_embedding``) or a ``SysLearner`` (its
    ``decode_prompts``), as in JAX; either way only the SAM embedding is
    computed. Returns (logits, scores, stability, points) of the kept
    masks, logits at S/4 resolution."""
    dev = _device(model)
    decode = getattr(model, "decode_prompts", None) or model.decode_from_embedding
    with torch.no_grad():
        img = torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(dev)
        emb, _ = model.image_encoder(model.normalize(img), return_fpn=False)
        labels = torch.ones((batch, 1), dtype=torch.int32, device=dev)
        all_logits, all_iou = [], []
        for start in range(0, len(grid), batch):
            chunk = grid[start:start + batch]
            pts = np.zeros((batch, 1, 2), np.float32)
            pts[:len(chunk), 0] = chunk
            out = decode(emb, points=torch.from_numpy(pts).to(dev), labels=labels,
                         return_upscaled=False)
            all_logits.append(out["masks"][:len(chunk), 0].float().cpu().numpy())
            all_iou.append(out["iou_pred"][:len(chunk), 0].float().cpu().numpy())
    logits = np.concatenate(all_logits)
    iou_pred = np.concatenate(all_iou)
    stab = stability_score(logits)
    keep = (iou_pred > pred_iou_thresh) & (stab > stability_thresh)
    return logits[keep], iou_pred[keep], stab[keep], np.asarray(grid)[keep]


def generate_masks(model, image, points_per_side: int = 32, batch: int = 64,
                   pred_iou_thresh: float = 0.88, stability_thresh: float = 0.95,
                   nms_thresh: float = 0.7, crop_n_layers: int = 0,
                   crop_overlap_ratio: float = 512 / 1500, output_mode: str = "binary_mask"):
    """AMG over one image with a ``Sam`` or a ``SysLearner``: encode once per crop, decode the
    layer's point grid in prompt batches, filter by predicted IoU and
    stability, NMS across all crops (on the model's device). image (1, S,
    S, 3) raw pixels, numpy. ``crop_n_layers`` > 0 adds zoomed-in crop
    layers (layer i: (2^i)^2 overlapping crops, downscaled grids) whose
    masks are pasted back into full-image space before the NMS. Returns
    dict(masks (K, S/4, S/4) bool, scores (K,), records); ``output_mode``
    'uncompressed_rle' / 'coco_rle' adds per-mask COCO RLE under 'rles'.
    The records' geometry is in the masks' (S/4) frame."""
    assert output_mode in ("binary_mask", "uncompressed_rle", "coco_rle"), output_mode
    image = np.asarray(image)
    s = image.shape[1]
    ms = s // 4
    grids = build_all_layer_point_grids(points_per_side, crop_n_layers, 2)
    crop_boxes, layer_idxs = generate_crop_boxes((s, s), crop_n_layers, crop_overlap_ratio)

    masks_all, scores_all, stab_all, points_all, cropbox_all = [], [], [], [], []
    for box, layer in zip(crop_boxes, layer_idxs):
        x0, y0, x1, y1 = box
        cw, ch = x1 - x0, y1 - y0
        grid = grids[layer] * np.asarray([s, s])  # points in the crop-resized frame
        if layer == 0:
            crop_img = image
        else:  # crop, then resize back to the model's square input
            crop_np = image[0, y0:y1, x0:x1].astype(np.uint8)
            crop_img = resize_longest_side(crop_np, s)[None].astype(np.float32)
            if crop_img.shape[1:3] != (s, s):
                padded = np.zeros((1, s, s, 3), np.float32)
                padded[0, :crop_img.shape[1], :crop_img.shape[2]] = crop_img[0]
                crop_img = padded
        logits, scores, stab, kept_pts = _decode_grid(
            model, crop_img, grid, batch, pred_iou_thresh, stability_thresh)
        if len(logits) == 0:
            continue
        scale = s / max(ch, cw) if layer > 0 else 1.0
        points_all.append(kept_pts / scale + np.asarray([x0, y0]))
        cropbox_all.append(np.tile(np.asarray(box, np.float32), (len(logits), 1)))
        stab_all.append(stab)
        m = logits > 0
        if layer > 0:  # the crop's masks resized to its footprint, pasted
            mh, mw = max(1, round(ch / 4)), max(1, round(cw / 4))
            ys = np.clip((np.arange(mh) * m.shape[1] / mh).astype(int), 0, m.shape[1] - 1)
            xs = np.clip((np.arange(mw) * m.shape[2] / mw).astype(int), 0, m.shape[2] - 1)
            resized = m[:, ys][:, :, xs]
            canvas = np.zeros((len(m), ms, ms), bool)
            oy, ox = y0 // 4, x0 // 4
            canvas[:, oy:oy + mh, ox:ox + mw] = resized[:, :ms - oy, :ms - ox]
            m = canvas
        masks_all.append(m)
        scores_all.append(scores)

    if not masks_all:
        out = {"masks": np.zeros((0, ms, ms), bool), "scores": np.zeros(0, np.float32),
               "records": []}
        if output_mode in ("uncompressed_rle", "coco_rle"):
            out["rles"] = []
        return out
    masks = np.concatenate(masks_all)
    scores = np.concatenate(scores_all)
    kept = mask_nms(masks, scores, nms_thresh, device=_device(model))
    out = {"masks": masks[kept], "scores": scores[kept]}
    rles = None
    if output_mode == "uncompressed_rle":
        rles = masks_to_rles(out["masks"])
    elif output_mode == "coco_rle":
        rles = [coco_encode_rle(r) for r in masks_to_rles(out["masks"])]
    if rles is not None:
        out["rles"] = rles
    stabs = np.concatenate(stab_all)[kept]
    points = np.concatenate(points_all)[kept] / 4.0
    cboxes = np.concatenate(cropbox_all)[kept] / 4.0
    boxes = batched_mask_to_box(out["masks"])
    out["records"] = [
        {
            "segmentation": rles[i] if rles is not None else out["masks"][i],
            "area": int(out["masks"][i].sum()),
            "bbox": box_xyxy_to_xywh(boxes[i]),
            "predicted_iou": float(out["scores"][i]),
            "point_coords": [points[i].tolist()],
            "stability_score": float(stabs[i]),
            "crop_box": box_xyxy_to_xywh(cboxes[i]),
        }
        for i in range(len(kept))
    ]
    return out
