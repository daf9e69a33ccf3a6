"""Inference heads and post-processing of the seg eval, PyTorch port of
``iuvl_tpu/inference/postprocess.py``.

``semantic_inference`` and ``instance_inference`` are tensor code that
runs where the model's outputs lie (the card on the main path);
``panoptic_merge`` is the JAX package's sequential host merge in numpy,
copied as it is; ``sem_seg_postprocess`` crops and resizes with
``jax.image.resize``'s weights (``ops/resize.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import resize_axis


def semantic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                       keep_sem_bgd: bool = False) -> torch.Tensor:
    """(Q, K) class logits and (Q, H, W) mask logits -> (K-1, H, W) class
    probabilities (K with ``keep_sem_bgd``)."""
    probs = torch.softmax(mask_cls, dim=-1)
    if not keep_sem_bgd:
        probs = probs[..., :-1]
    return torch.einsum("qc,qhw->chw", probs, torch.sigmoid(mask_pred))


def instance_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor, topk: int = 100,
                       thing_mask: torch.Tensor | None = None) -> dict:
    """The top-k (query, class) pairs of the (Q, K) class logits (K with
    the background column) -> fixed-shape per-instance binary masks,
    scores, classes and a thing flag. The mask score is the mean sigmoid
    over a mask's positive pixels; it is computed once per query and then
    gathered, which gives the same values as computing it on each gathered
    mask. Ties in the top-k may come in another order than
    ``jax.lax.top_k``'s (lower index first)."""
    q, k = mask_cls.shape
    flat = torch.softmax(mask_cls, dim=-1)[:, :-1].reshape(-1)
    scores, top = torch.topk(flat, min(topk, flat.shape[0]))
    labels = top % (k - 1)
    query = top // (k - 1)
    binary = mask_pred > 0
    per_query = ((torch.sigmoid(mask_pred) * binary).sum((1, 2))
                 / (binary.sum((1, 2)) + 1e-6))
    valid = (thing_mask[labels] if thing_mask is not None
             else torch.ones_like(labels, dtype=torch.bool))
    final = scores * per_query[query]
    return {"pred_masks": binary[query], "scores": torch.where(valid, final, 0.0),
            "pred_classes": labels, "valid": valid}


def panoptic_merge(mask_cls: np.ndarray, mask_pred: np.ndarray, thing_ids: set[int],
                   object_mask_threshold: float = 0.8, overlap_threshold: float = 0.8):
    """Host-side sequential panoptic merge of (Q, K) class logits and
    (Q, H, W) mask logits. Returns (panoptic_seg (H, W) int32,
    segments_info list)."""
    num_classes = mask_cls.shape[-1] - 1
    probs = _softmax_np(mask_cls)
    scores = probs.max(-1)
    labels = probs.argmax(-1)
    sig = 1.0 / (1.0 + np.exp(-mask_pred))

    keep = (labels != num_classes) & (scores > object_mask_threshold)
    cur_scores = scores[keep]
    cur_classes = labels[keep]
    cur_masks = sig[keep]

    h, w = mask_pred.shape[-2:]
    panoptic_seg = np.zeros((h, w), dtype=np.int32)
    segments_info: list[dict] = []
    if cur_masks.shape[0] == 0:
        return panoptic_seg, segments_info

    cur_prob_masks = cur_scores[:, None, None] * cur_masks
    cur_mask_ids = cur_prob_masks.argmax(0)
    stuff_memory: dict[int, int] = {}
    segment_id = 0
    for k_i in range(cur_classes.shape[0]):
        pred_class = int(cur_classes[k_i])
        isthing = pred_class in thing_ids
        mask = (cur_mask_ids == k_i) & (cur_masks[k_i] >= 0.5)
        # The reference's overlap ratio takes the full argmax region over
        # the >= 0.5 area.
        mask_area = (cur_mask_ids == k_i).sum()
        original_area = (cur_masks[k_i] >= 0.5).sum()
        if mask_area > 0 and original_area > 0 and mask.sum() > 0:
            if mask_area / original_area < overlap_threshold:
                continue
            if not isthing:
                if pred_class in stuff_memory:
                    panoptic_seg[mask] = stuff_memory[pred_class]
                    continue
                stuff_memory[pred_class] = segment_id + 1
            segment_id += 1
            panoptic_seg[mask] = segment_id
            segments_info.append(
                {"id": segment_id, "isthing": bool(isthing), "category_id": pred_class}
            )
    return panoptic_seg, segments_info


def sem_seg_postprocess(result: torch.Tensor, img_size: tuple[int, int], out_height: int,
                        out_width: int) -> torch.Tensor:
    """(C, H, W): crop away the padding to ``img_size``, then bilinearly
    resize to the original (out_height, out_width)."""
    result = result[..., : img_size[0], : img_size[1]]
    return resize_axis(resize_axis(result, 1, out_height, "linear"), 2, out_width, "linear")


def _softmax_np(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)
