"""Tracing and the run log, port of ``iuvl_tpu/runtime/observability.py``:
``profile_trace`` records a ``torch.profiler`` trace (host and, on the
card, device activity) into a directory as a Chrome trace;
``MetricsLogger`` appends JSONL records under a run
id that a resumed run keeps. (JAX's ``nan_guard`` switches a JAX debug
flag and has no counterpart here.)"""

from __future__ import annotations

import contextlib
import json
import os
import time
import uuid
from typing import Any

import torch


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the block; on exit write ``logdir/trace.json`` (Chrome's
    trace format) and yield the profiler for its ``key_averages()``."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class MetricsLogger:
    """Append-only JSONL metrics log with a resumable run id."""

    def __init__(self, run_dir: str, resume: bool = False):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        id_path = os.path.join(run_dir, "run_id")
        if resume and os.path.exists(id_path):
            with open(id_path) as f:
                self.run_id = f.read().strip()
        else:
            self.run_id = uuid.uuid4().hex[:12]
            with open(id_path, "w") as f:
                f.write(self.run_id)

    def log(self, step: int, metrics: dict[str, Any]):
        record = {
            "run_id": self.run_id,
            "step": int(step),
            "time": time.time(),
            **{k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()},
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
