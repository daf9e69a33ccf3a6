"""Checkpoints, port of ``iuvl_tpu/runtime/checkpoint.py`` over ``torch.save``.

Runs go into auto-numbered ``run_N`` directories; a ``CheckpointManager``
keeps one file a step (``<step>.pt``: a dict of the step, the model's
state dict and the optimizer's state) and the newest ``max_to_keep``.
``align_and_update_params`` is the fuzzy loader of pretrained weights:
each key of the model's state dict takes the loaded tensor of the same
key and shape, else the one whose key shares the longest suffix of
dot-separated segments with it and has its shape.
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping

import torch


def _run_numbers(base_dir: str, prefix: str) -> list[int]:
    return [int(m.group(1)) for d in os.listdir(base_dir)
            if (m := re.fullmatch(rf"{prefix}(\d+)", d))]


def latest_run_dir(base_dir: str, prefix: str = "run_") -> str | None:
    """The highest-numbered existing run directory, or None (a resumed run
    continues there)."""
    if not os.path.isdir(base_dir):
        return None
    existing = _run_numbers(base_dir, prefix)
    if not existing:
        return None
    return os.path.join(base_dir, f"{prefix}{max(existing)}")


def next_run_dir(base_dir: str, prefix: str = "run_") -> str:
    """A new run directory, numbered one past the highest existing one."""
    os.makedirs(base_dir, exist_ok=True)
    run = max(_run_numbers(base_dir, prefix), default=0) + 1
    path = os.path.join(base_dir, f"{prefix}{run}")
    os.makedirs(path, exist_ok=True)
    return path


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := re.fullmatch(r"(\d+)\.pt", f)))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: Mapping[str, Any]) -> bool:
        """Write ``state`` as step ``step`` (a step at or below the newest
        saved one is skipped, as Orbax's manager skips it; returns whether
        it was written), then drop the oldest past ``max_to_keep``."""
        latest = self.latest_step
        if latest is not None and step <= latest:
            return False
        tmp = self._path(step) + ".tmp"
        torch.save(dict(state), tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def restore(self, step: int | None = None, map_location="cpu"):
        """The state saved at ``step`` (the newest by default), or None."""
        step = step if step is not None else self.latest_step
        if step is None:
            return None
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    @property
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None


def align_and_update_params(template: Mapping[str, torch.Tensor],
                            loaded: Mapping[str, torch.Tensor]) -> tuple[dict, list[str]]:
    """Fuzzy weight loading over state dicts: each key of ``template``
    takes ``loaded``'s tensor of the same key and shape; else the first, in
    ``loaded``'s order, of those of its shape whose key shares the longest
    suffix of dot-separated segments with it (at least one); else it keeps
    its own value. Returns (the merged dict in ``template``'s order, the
    log: ``remap <loaded key> -> <key>`` and ``missing <key> (kept init)``)."""
    log = []
    merged = {}
    for key, leaf in template.items():
        hit = loaded.get(key)
        if hit is not None and tuple(hit.shape) == tuple(leaf.shape):
            merged[key] = hit
            continue
        best, best_len = None, -1
        a = key.split(".")[::-1]
        for lk, lv in loaded.items():
            if tuple(lv.shape) != tuple(leaf.shape):
                continue
            n = 0
            for x, y in zip(a, lk.split(".")[::-1]):
                if x != y:
                    break
                n += 1
            if n > best_len and n > 0:
                best, best_len = lk, n
        if best is not None:
            merged[key] = loaded[best]
            log.append(f"remap {best} -> {key}")
        else:
            merged[key] = leaf
            log.append(f"missing {key} (kept init)")
    return merged, log
