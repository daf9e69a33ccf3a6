"""Instance segmentation AP evaluator (COCO-style), the port's own copy of
``iuvl_tpu/evaluation/instance.py`` (numpy), with COCOeval's semantics:

- per-(image, class) greedy matching by score order at IoU thresholds
  0.5:0.95:0.05, with ``maxDets=100`` detections kept per image and class;
- COCO area ranges (all / small < 32² / medium 32²-96² / large > 96²) in
  mask pixels: gt outside the range are ignored, and so are unmatched
  detections outside it;
- 101-point interpolated AP on the precision envelope, scores merged per
  class across images, classes without countable gt in a range left out
  of that range's mean;
- reported: AP, AP50, AP75, APs, APm, APl (segm), x100.

The greedy match is vectorised over (area range x threshold) cells, the gt
as the inner lanes.
"""

from __future__ import annotations

import numpy as np

# COCO area ranges in pixels² (cocoeval.py Params.setDetParams).
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
_RANGE_KEYS = ("all", "small", "medium", "large")


def mask_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """pred (P, H*W) bool, gt (G, H*W) bool -> (P, G) IoU."""
    pred_f = pred.astype(np.float64)
    gt_f = gt.astype(np.float64)
    inter = pred_f @ gt_f.T
    union = pred_f.sum(1)[:, None] + gt_f.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


class InstanceAPEvaluator:
    """Streaming COCO segm-AP evaluator: feed per-image predictions with
    :meth:`process`, reduce across shards with :meth:`merge`, then
    :meth:`evaluate`."""

    def __init__(self, num_classes: int, iou_thresholds=None, max_dets: int = 100):
        self.num_classes = num_classes
        self.iou_thresholds = np.asarray(
            iou_thresholds
            if iou_thresholds is not None
            else np.round(np.arange(0.5, 1.0, 0.05), 2)
        )
        self.max_dets = max_dets
        self.reset()

    def reset(self):
        # Per class: list of (scores (P,), matched (P, A, T) bool,
        # dt_ignore (P, A, T) bool) blocks, one per processed image.
        self.dets: dict[int, list] = {c: [] for c in range(self.num_classes)}
        # Per class: (A,) counts of non-ignored gt.
        self.n_gt: dict[int, np.ndarray] = {
            c: np.zeros(len(_RANGE_KEYS), np.int64) for c in range(self.num_classes)
        }

    # ------------------------------------------------------------------ #
    def process(self, pred_masks, pred_scores, pred_classes, gt_masks, gt_classes):
        """pred_masks (P, H, W) bool, scores (P,), classes (P,);
        gt_masks (G, H, W) bool, gt_classes (G,). One call per image."""
        # reshape(n, -1) cannot infer -1 when n == 0 (empty preds or
        # all-padding gt must not abort the eval run).
        pred_masks = np.asarray(pred_masks, bool)
        pred_masks = pred_masks.reshape(len(pred_masks), pred_masks[0].size
                                        if len(pred_masks) else 0)
        gt_masks = np.asarray(gt_masks, bool)
        gt_masks = gt_masks.reshape(len(gt_masks), gt_masks[0].size
                                    if len(gt_masks) else 0)
        pred_scores = np.asarray(pred_scores, np.float64)
        pred_classes = np.asarray(pred_classes)
        gt_classes = np.asarray(gt_classes)

        n_a = len(_RANGE_KEYS)
        thr = self.iou_thresholds
        n_t = len(thr)
        lo = np.array([AREA_RANGES[k][0] for k in _RANGE_KEYS])
        hi = np.array([AREA_RANGES[k][1] for k in _RANGE_KEYS])

        for c in np.unique(np.concatenate([pred_classes, gt_classes])):
            c = int(c)
            p_idx = np.where(pred_classes == c)[0]
            g_idx = np.where(gt_classes == c)[0]
            # maxDets: top-N by score per image per class (cocoeval
            # evaluateImg's dt = dt[0:maxDet]).
            order = p_idx[np.argsort(-pred_scores[p_idx], kind="stable")]
            order = order[: self.max_dets]
            p, g = len(order), len(g_idx)

            gt_area = gt_masks[g_idx].sum(1).astype(np.float64)  # (G,)
            gt_ig = (gt_area[None, :] < lo[:, None]) | (
                gt_area[None, :] > hi[:, None]
            )  # (A, G)
            if c not in self.n_gt:
                self.n_gt[c] = np.zeros(n_a, np.int64)
            self.n_gt[c] += (~gt_ig).sum(1)
            if p == 0:
                continue

            dt_area = pred_masks[order].sum(1).astype(np.float64)  # (P,)
            dt_out = (dt_area[None, :] < lo[:, None]) | (
                dt_area[None, :] > hi[:, None]
            )  # (A, P)
            ious = (
                mask_iou(pred_masks[order], gt_masks[g_idx])
                if g
                else np.zeros((p, 0))
            )

            matched = np.zeros((p, n_a, n_t), bool)
            match_ig = np.zeros((p, n_a, n_t), bool)  # matched to ignored gt
            taken = np.zeros((n_a, n_t, g), bool)
            for pi in range(p):
                if g == 0:
                    break
                iou_row = ious[pi]  # (G,)
                # candidates above threshold, not yet taken: (A, T, G)
                cand = (iou_row[None, None, :] >= thr[None, :, None]) & ~taken
                non_ig = cand & ~gt_ig[:, None, :]
                ig = cand & gt_ig[:, None, :]
                # Prefer the best non-ignored gt; fall back to the best
                # ignored one (cocoeval: gts sorted ignored-last; an
                # ignored match marks the dt ignored).
                has_non_ig = non_ig.any(-1)  # (A, T)
                has_ig = ig.any(-1)
                pick_pool = np.where(has_non_ig[..., None], non_ig, ig)
                best = np.argmax(
                    np.where(pick_pool, iou_row[None, None, :], -1.0), axis=-1
                )  # (A, T)
                hit = has_non_ig | has_ig
                a_i, t_i = np.nonzero(hit)
                taken[a_i, t_i, best[a_i, t_i]] = True
                matched[pi] = hit
                match_ig[pi] = hit & ~has_non_ig
            # dtIg: matched to an ignored gt, OR unmatched and outside the
            # area range (cocoeval evaluateImg last line).
            dt_ig = match_ig | (~matched & dt_out.T[:, :, None])
            self.dets.setdefault(c, []).append(
                (pred_scores[order], matched, dt_ig)
            )

    # ------------------------------------------------------------------ #
    def merge(self, other):
        for c, lst in other.dets.items():
            self.dets.setdefault(c, []).extend(lst)
        for c, n in other.n_gt.items():
            if c not in self.n_gt:
                self.n_gt[c] = np.zeros(len(_RANGE_KEYS), np.int64)
            self.n_gt[c] += n

    def _ap(self, recalls, precisions) -> float:
        # 101-point interpolation on the precision envelope (equivalent to
        # cocoeval accumulate's maximum-to-the-right + searchsorted).
        ap = 0.0
        for t in np.linspace(0, 1, 101):
            prec = precisions[recalls >= t]
            ap += prec.max() if prec.size else 0.0
        return ap / 101

    def _ap_matrix(self) -> np.ndarray:
        """(A, T, C) AP per area range / threshold / class; NaN where the
        class has no non-ignored gt in that range."""
        n_a, n_t = len(_RANGE_KEYS), len(self.iou_thresholds)
        classes = sorted(set(self.dets) | set(self.n_gt))
        out = np.full((n_a, n_t, len(classes)), np.nan)
        for ci, c in enumerate(classes):
            blocks = self.dets.get(c, [])
            if blocks:
                scores = np.concatenate([b[0] for b in blocks])
                matched = np.concatenate([b[1] for b in blocks])  # (D, A, T)
                dt_ig = np.concatenate([b[2] for b in blocks])
                order = np.argsort(-scores, kind="mergesort")
                matched, dt_ig = matched[order], dt_ig[order]
            n_gt = self.n_gt.get(c)
            if n_gt is None:
                continue
            for a in range(n_a):
                npig = int(n_gt[a])
                if npig == 0:
                    continue  # stays NaN -> excluded from the mean
                if not blocks:
                    out[a, :, ci] = 0.0
                    continue
                for t in range(n_t):
                    keep = ~dt_ig[:, a, t]
                    m = matched[keep, a, t]
                    tp = np.cumsum(m)
                    fp = np.cumsum(~m)
                    recalls = tp / npig
                    precisions = tp / np.maximum(tp + fp, 1)
                    out[a, t, ci] = self._ap(recalls, precisions)
        return out

    def evaluate(self) -> dict[str, float]:
        ap = self._ap_matrix()
        if np.isnan(ap).all():
            return {}

        def mean(a_slice) -> float:
            # -1 where no class has countable gt (pycocotools summarize's
            # "a -1 means the metric cannot be computed").
            v = a_slice[~np.isnan(a_slice)]
            return 100 * float(v.mean()) if v.size else -1.0

        idx50 = int(np.argmin(np.abs(self.iou_thresholds - 0.5)))
        idx75 = int(np.argmin(np.abs(self.iou_thresholds - 0.75)))
        return {
            "AP": mean(ap[0]),
            "AP50": mean(ap[0, idx50]),
            "AP75": mean(ap[0, idx75]),
            "APs": mean(ap[1]),
            "APm": mean(ap[2]),
            "APl": mean(ap[3]),
        }
