"""Semantic segmentation evaluator (confusion-matrix mIoU), the port's own
copy of ``iuvl_tpu/evaluation/semseg.py`` (numpy).

Accumulates a (K+1, K+1) confusion matrix of predicted argmax against
ground truth (the ignore label folded into the last bin) and reports mIoU,
fwIoU, mACC and pACC; shards reduce by summing their matrices.
"""

from __future__ import annotations

import numpy as np


class SemSegEvaluator:
    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.reset()

    def reset(self):
        n = self.num_classes + 1
        self._conf_matrix = np.zeros((n, n), dtype=np.int64)

    def process(self, pred: np.ndarray, gt: np.ndarray):
        """pred: (H, W) argmax class ids; gt: (H, W) with ignore_label."""
        pred = np.asarray(pred, np.int64).reshape(-1)
        gt = np.asarray(gt, np.int64).reshape(-1)
        gt = gt.copy()
        gt[gt == self.ignore_label] = self.num_classes
        self._conf_matrix += np.bincount(
            (self.num_classes + 1) * pred + gt,
            minlength=self._conf_matrix.size,
        ).reshape(self._conf_matrix.shape)

    def merge(self, other: "SemSegEvaluator"):
        self._conf_matrix += other._conf_matrix

    def evaluate(self) -> dict[str, float]:
        acc = np.full(self.num_classes, np.nan)
        iou = np.full(self.num_classes, np.nan)
        tp = self._conf_matrix.diagonal()[: self.num_classes].astype(float)
        pos_gt = self._conf_matrix[: self.num_classes + 1, : self.num_classes].sum(0).astype(float)
        # Exclude the gt-ignore column (reference segmentation_evaluation
        # .py:146 sums conf[:-1, :-1]): predictions on ignore pixels must
        # not inflate the union.
        pos_pred = self._conf_matrix[: self.num_classes, : self.num_classes].sum(1).astype(float)
        class_weights = pos_gt / max(pos_gt.sum(), 1)
        acc_valid = pos_gt > 0
        acc[acc_valid] = tp[acc_valid] / pos_gt[acc_valid]
        union = pos_gt + pos_pred - tp
        iou_valid = union > 0
        iou[iou_valid] = tp[iou_valid] / union[iou_valid]

        miou = float(np.nanmean(iou)) * 100 if iou_valid.any() else 0.0
        fiou = float(np.nansum(iou * class_weights)) * 100
        macc = float(np.nanmean(acc)) * 100 if acc_valid.any() else 0.0
        pacc = float(tp.sum() / max(pos_gt.sum(), 1)) * 100
        return {"mIoU": miou, "fwIoU": fiou, "mACC": macc, "pACC": pacc}
