"""Loss meters and console formatting, port of ``iuvl_tpu/runtime/metrics.py``
(the reference trainer's LossMeter / AverageMeter and its metric display)."""

from __future__ import annotations

import time
from collections import defaultdict


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class LossMeter:
    """Dict of AverageMeters keyed by loss name."""

    def __init__(self):
        self.meters: dict[str, AverageMeter] = defaultdict(AverageMeter)

    def update(self, losses: dict, n: int = 1):
        for k, v in losses.items():
            self.meters[k].update(float(v), n)

    def averages(self) -> dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self):
        for m in self.meters.values():
            m.reset()


def format_metrics(metrics: dict, precision: int = 4) -> str:
    return "  ".join(f"{k}={float(v):.{precision}f}" for k, v in sorted(metrics.items()))


class Throughput:
    """Items a second since the last reset, on the host clock."""

    def __init__(self):
        self.reset()

    def update(self, n: int):
        self.n += n

    def rate(self) -> float:
        return self.n / max(time.perf_counter() - self.t0, 1e-9)

    def reset(self):
        self.t0 = time.perf_counter()
        self.n = 0
