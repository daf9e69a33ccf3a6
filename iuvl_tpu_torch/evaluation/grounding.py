"""Referring-segmentation (grounding) evaluator, the port's own copy of
``iuvl_tpu/evaluation/grounding.py`` (numpy): cumulative IoU (the sum of
intersections over the sum of unions), mean per-sample IoU, and
precision@{0.5..0.9}.
"""

from __future__ import annotations

import numpy as np


class GroundingEvaluator:
    def __init__(self, thresholds=(0.5, 0.6, 0.7, 0.8, 0.9)):
        self.thresholds = thresholds
        self.reset()

    def reset(self):
        self.cum_i = 0.0
        self.cum_u = 0.0
        self.ious: list[float] = []
        self.hits = np.zeros(len(self.thresholds), np.int64)

    def process(self, pred_mask: np.ndarray, gt_mask: np.ndarray):
        """Binary (H, W) masks for one phrase."""
        p = np.asarray(pred_mask, bool)
        g = np.asarray(gt_mask, bool)
        inter = float((p & g).sum())
        union = float((p | g).sum())
        iou = inter / union if union > 0 else 0.0
        self.cum_i += inter
        self.cum_u += union
        self.ious.append(iou)
        for i, t in enumerate(self.thresholds):
            self.hits[i] += iou >= t

    def merge(self, other: "GroundingEvaluator"):
        self.cum_i += other.cum_i
        self.cum_u += other.cum_u
        self.ious.extend(other.ious)
        self.hits += other.hits

    def evaluate(self) -> dict[str, float]:
        n = max(len(self.ious), 1)
        out = {
            "cIoU": 100.0 * self.cum_i / max(self.cum_u, 1.0),
            "mIoU": 100.0 * float(np.mean(self.ious)) if self.ious else 0.0,
        }
        for i, t in enumerate(self.thresholds):
            out[f"precision@{t}"] = 100.0 * self.hits[i] / n
        return out
