"""Optimizer and LR schedule, PyTorch port of ``iuvl_tpu/train/optimizer.py``.

The optax chain clip-by-global-norm -> AdamW (weight decay masked off
norms, biases, embeddings and tables) -> LR multipliers -> freeze, built
on ``torch.optim.AdamW`` parameter groups: one group per (decay, LR
multiplier), frozen parameters left out, the global norm taken over every
gradient first. The schedule is detectron2's WarmupMultiStepLR, indexed by
the number of updates made so far, as optax counts: the first update runs
at ``schedule(0)``.

The decay and multiplier rules match substrings of the JAX package's
parameter paths (``image_encoder/block0/norm1/scale``), so a caller passes
each parameter's flax path (``models/xdecoder/convert.py``
``flax_paths``); the port's own names (``...norm1.weight``) would not
match the same tokens.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping, Sequence

import torch

NO_DECAY_TOKENS = (
    "bias", "scale", "norm", "pos_embed", "rel_pos", "positional_embedding",
    "token_embedding", "query_feat", "query_embed", "level_embed", "logit_scale",
    "point_embeddings", "not_a_point_embed", "no_mask_embed", "iou_token", "mask_tokens",
    "gaussian_matrix", "pos_embed_caping",
)


def decay_mask(paths: Mapping[str, str]) -> dict[str, bool]:
    """name -> True where weight decay applies, from each parameter's path
    (``iuvl_tpu`` ``decay_mask``)."""
    return {name: not any(t in path.lower() for t in NO_DECAY_TOKENS)
            for name, path in paths.items()}


def lr_multiplier(path: str, multipliers: Mapping[str, float]) -> float:
    p = path.lower()
    for key, m in multipliers.items():
        if key.lower() in p:
            return m
    return 1.0


def build_lr_schedule(base_lr: float, total_steps: int, warmup_iters: int = 10,
                      warmup_factor: float = 1.0, milestones: Sequence[float] = (0.4, 0.8),
                      gamma: float = 0.1) -> Callable[[int], float]:
    """WarmupMultiStepLR: step -> learning rate."""
    bounds = sorted(int(f * total_steps) if f <= 1 else int(f) for f in milestones)

    def schedule(step: int) -> float:
        warm = (warmup_factor + (1.0 - warmup_factor) * step / max(warmup_iters, 1)
                if step < warmup_iters else 1.0)
        lr = base_lr
        for b in bounds:
            if step >= b:
                lr *= gamma
        return warm * lr

    return schedule


class Optimizer:
    """clip -> AdamW(masked decay) -> LR multipliers -> freeze over
    ``named_params`` (name, parameter) pairs; ``paths`` maps a name to the
    path the decay, multiplier and freeze rules read (the name itself when
    absent). :meth:`step` updates from the parameters' ``.grad`` and
    returns the global gradient norm before clipping."""

    def __init__(self, named_params: Iterable, paths: Mapping[str, str] | None = None,
                 base_lr: float = 1e-4, weight_decay: float = 0.05, total_steps: int = 10000,
                 clip_norm: float = 5.0, lr_multipliers: Mapping[str, float] | None = None,
                 warmup_iters: int = 10, milestones: Sequence[float] = (0.4, 0.8),
                 gamma: float = 0.1, frozen_substrings: Sequence[str] = ()):
        named = list(named_params)
        paths = {name: (paths or {}).get(name, name) for name, _ in named}
        decay = decay_mask(paths)
        self.params = [p for _, p in named]
        self.clip_norm = clip_norm
        self.schedule = build_lr_schedule(base_lr, total_steps, warmup_iters=warmup_iters,
                                          milestones=milestones, gamma=gamma)
        groups: dict = {}
        for name, p in named:
            path = paths[name]
            if any(s.lower() in path.lower() for s in frozen_substrings):
                continue
            key = (decay[name], lr_multiplier(path, lr_multipliers or {}))
            groups.setdefault(key, []).append(p)
        self.groups = [dict(params=ps, weight_decay=weight_decay if on else 0.0, mult=mult)
                       for (on, mult), ps in groups.items()]
        self.adamw = torch.optim.AdamW(
            [dict(params=g["params"], weight_decay=g["weight_decay"], lr=0.0)
             for g in self.groups], lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        self.count = 0  # updates made, optax's count

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        g_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        # optax clip_by_global_norm: where(norm < max, g, g / norm * max).
        if g_norm >= self.clip_norm:
            for g in grads:
                g.div_(g_norm).mul_(self.clip_norm)
        lr = self.schedule(self.count)
        for group, g in zip(self.adamw.param_groups, self.groups):
            group["lr"] = lr * g["mult"]
        self.adamw.step()
        self.count += 1
        return g_norm

    def state_dict(self) -> dict:
        """The update count and AdamW's moments, for a checkpoint."""
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])
