"""Classification top-k evaluator (top-1 / top-5 accuracy over logits), the
port's own copy of ``iuvl_tpu/evaluation/classification.py`` (numpy).
"""

from __future__ import annotations

import numpy as np


class ClassificationEvaluator:
    def __init__(self, ks=(1, 5)):
        self.ks = ks
        self.reset()

    def reset(self):
        self.hits = {k: 0 for k in self.ks}
        self.total = 0

    def process(self, logits: np.ndarray, labels: np.ndarray):
        logits = np.asarray(logits)
        labels = np.asarray(labels).reshape(-1)
        order = np.argsort(-logits, axis=-1)
        for k in self.ks:
            self.hits[k] += int((order[:, :k] == labels[:, None]).any(1).sum())
        self.total += len(labels)

    def merge(self, other):
        for k in self.ks:
            self.hits[k] += other.hits[k]
        self.total += other.total

    def evaluate(self) -> dict[str, float]:
        n = max(self.total, 1)
        return {f"top{k}": 100.0 * self.hits[k] / n for k in self.ks}
