"""Interactive segmentation evaluator: NoC@IoU + mIoU@iteration, the
port's own copy of ``iuvl_tpu/evaluation/interactive.py`` (host numpy).

Per sample, a length-``max_clicks`` IoU trajectory; NoC@t = mean number of
clicks needed to first reach IoU >= t (censored at max_clicks); also
mIoU after each iteration and the share of failures. Protocol constants
(the reference's xdecoder_model.py:723,889 and configs/step1.yaml:492-497):
20 clicks at most, stop IoU 0.925.
"""

from __future__ import annotations

import numpy as np


class InteractiveEvaluator:
    def __init__(self, max_clicks: int = 20, iou_thresholds=(0.5, 0.8, 0.85, 0.9)):
        self.max_clicks = max_clicks
        self.iou_thresholds = iou_thresholds
        self.reset()

    def reset(self):
        self.trajectories: list[np.ndarray] = []

    def process(self, iou_per_click: np.ndarray):
        """iou_per_click: (max_clicks,) IoU after click k (monotone not
        required)."""
        traj = np.asarray(iou_per_click, np.float64)
        assert traj.shape[0] == self.max_clicks
        self.trajectories.append(traj)

    def merge(self, other: "InteractiveEvaluator"):
        self.trajectories.extend(other.trajectories)

    def evaluate(self) -> dict[str, float]:
        if not self.trajectories:
            return {}
        t = np.stack(self.trajectories)  # (N, C)
        out: dict[str, float] = {}
        for thr in self.iou_thresholds:
            reached = t >= thr  # (N, C)
            first = np.where(
                reached.any(1), reached.argmax(1) + 1, self.max_clicks
            ).astype(np.float64)
            out[f"NoC@{thr}"] = float(first.mean())
            out[f"Fail@{thr}"] = float((~reached.any(1)).mean()) * 100.0
        for it in sorted({i for i in (1, 3, 5, 10, self.max_clicks) if i <= self.max_clicks}):
            out[f"mIoU@{it}"] = float(t[:, it - 1].mean()) * 100.0
        return out
