"""Panoptic quality (PQ / SQ / RQ) evaluator, the port's own copy of
``iuvl_tpu/evaluation/panoptic.py`` (numpy).

Segments match iff IoU > 0.5 (unique by construction), the prediction's
overlap with gt void left out of the union as panopticapi does;
PQ = sum IoU_TP / (|TP| + |FP|/2 + |FN|/2), split into things and stuff.
"""

from __future__ import annotations

import numpy as np


class PanopticEvaluator:
    def __init__(self, thing_ids: set[int] | None = None):
        self.thing_ids = thing_ids or set()
        self.reset()

    def reset(self):
        # per-category accumulators
        self.iou_sum: dict[int, float] = {}
        self.tp: dict[int, int] = {}
        self.fp: dict[int, int] = {}
        self.fn: dict[int, int] = {}

    def _acc(self, d, cat, v=1):
        d[cat] = d.get(cat, 0) + v

    def process(
        self,
        pred_seg: np.ndarray,  # (H, W) segment ids (0 = void)
        pred_info: list[dict],  # [{id, category_id, ...}]
        gt_seg: np.ndarray,
        gt_info: list[dict],
    ):
        pred_seg = np.asarray(pred_seg)
        gt_seg = np.asarray(gt_seg)
        pred_cats = {s["id"]: s["category_id"] for s in pred_info}
        gt_cats = {s["id"]: s["category_id"] for s in gt_info}

        # Joint histogram of (gt_id, pred_id) overlaps.
        combined = gt_seg.astype(np.int64) * (pred_seg.max() + 2) + pred_seg
        ids, counts = np.unique(combined, return_counts=True)
        inter = {}
        base = pred_seg.max() + 2
        for v, c in zip(ids, counts):
            inter[(int(v // base), int(v % base))] = int(c)

        gt_areas = {int(i): int(c) for i, c in zip(*np.unique(gt_seg, return_counts=True))}
        pred_areas = {int(i): int(c) for i, c in zip(*np.unique(pred_seg, return_counts=True))}

        matched_gt, matched_pred = set(), set()
        for (gid, pid), i_area in inter.items():
            if gid == 0 or pid == 0 or gid not in gt_cats or pid not in pred_cats:
                continue
            if gt_cats[gid] != pred_cats[pid]:
                continue
            # panopticapi rule: the pred segment's overlap with gt VOID
            # (id 0) is subtracted from the union so spilling into
            # unlabeled regions doesn't sink the IoU below the 0.5 match.
            union = (gt_areas[gid] + pred_areas[pid] - i_area
                     - inter.get((0, pid), 0))
            iou = i_area / union if union > 0 else 0.0
            if iou > 0.5:
                cat = gt_cats[gid]
                self._acc(self.tp, cat)
                self.iou_sum[cat] = self.iou_sum.get(cat, 0.0) + iou
                matched_gt.add(gid)
                matched_pred.add(pid)

        for gid, cat in gt_cats.items():
            if gid not in matched_gt:
                self._acc(self.fn, cat)
        for pid, cat in pred_cats.items():
            if pid not in matched_pred:
                self._acc(self.fp, cat)

    def merge(self, other):
        for d_self, d_other in (
            (self.iou_sum, other.iou_sum), (self.tp, other.tp),
            (self.fp, other.fp), (self.fn, other.fn),
        ):
            for k, v in d_other.items():
                d_self[k] = d_self.get(k, 0) + v

    def evaluate(self) -> dict[str, float]:
        cats = set(self.tp) | set(self.fp) | set(self.fn)
        if not cats:
            return {}

        def pq_set(subset):
            pqs, sqs, rqs = [], [], []
            for c in subset:
                tp = self.tp.get(c, 0)
                fp = self.fp.get(c, 0)
                fn = self.fn.get(c, 0)
                if tp + fp + fn == 0:
                    continue
                sq = self.iou_sum.get(c, 0.0) / tp if tp else 0.0
                rq = tp / (tp + 0.5 * fp + 0.5 * fn)
                pqs.append(sq * rq)
                sqs.append(sq)
                rqs.append(rq)
            if not pqs:
                return 0.0, 0.0, 0.0
            return (
                100 * float(np.mean(pqs)),
                100 * float(np.mean(sqs)),
                100 * float(np.mean(rqs)),
            )

        pq, sq, rq = pq_set(cats)
        things = [c for c in cats if c in self.thing_ids]
        stuff = [c for c in cats if c not in self.thing_ids]
        pq_th, sq_th, rq_th = pq_set(things)
        pq_st, sq_st, rq_st = pq_set(stuff)
        return {
            "PQ": pq, "SQ": sq, "RQ": rq,
            "PQ_th": pq_th, "SQ_th": sq_th, "RQ_th": rq_th,
            "PQ_st": pq_st, "SQ_st": sq_st, "RQ_st": rq_st,
        }
