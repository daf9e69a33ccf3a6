"""The seg-stream train step, PyTorch port of ``iuvl_tpu/train/train_step.py``
(``make_train_step``).

One step: ``forward_seg``, the object-query block of the outputs
(``split_seg_outputs``), the criterion (matching costs, the host
Hungarian solve, the weighted losses), one backward and one optimizer
update. PyTorch runs it eagerly; the JAX package jits the same program.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from ..losses.criterion import SegCriterion, SegTargets
from ..losses.matcher import batched_hungarian
from ..ops.point_sample import generator_draws, given_draws
from .optimizer import Optimizer


@dataclasses.dataclass
class TrainState:
    """The optimizer over the model's parameters, which it updates in
    place; ``step`` is the number of updates made (optax's count)."""

    optimizer: Optimizer

    @property
    def step(self) -> int:
        return self.optimizer.count


def split_seg_outputs(outputs: dict, num_queries: int) -> dict:
    """The object-query block (the first ``num_queries - 1`` queries) of the
    head outputs and of every aux layer (reference forward_seg:352-380)."""
    nq = num_queries

    def block(o):
        return {"pred_logits": o["pred_logits"][:, : nq - 1],
                "pred_masks": o["pred_masks"][:, : nq - 1]}

    obj = block(outputs)
    obj["aux_outputs"] = [block(a) for a in outputs["aux_outputs"]]
    return obj


def make_train_step(model, criterion: SegCriterion, match_points: int = 12544) -> Callable:
    """Returns ``train_step(state, images, text_embeddings, targets,
    generator, assignments=None) -> (state, metrics)``.

    ``generator``: a ``torch.Generator`` for the criterion's random points,
    or a mapping of given draws (``ops.point_sample.given_draws``).
    ``assignments``: the kept layers' (B, T) assignments, to skip the
    matcher (a caller that holds several paths to one matching); the
    metrics carry the ones used. Every parameter takes part in the update,
    as in the JAX step: one that the seg forward does not read gets a zero
    gradient, so weight decay still reaches it."""

    def train_step(state: TrainState, images, text_embeddings, targets: SegTargets,
                   generator, assignments=None):
        draw = (given_draws(generator) if isinstance(generator, Mapping)
                else generator_draws(generator, images.device))
        for p in model.parameters():
            p.grad = None
        outputs = model.forward_seg(images, text_embeddings)
        obj = split_seg_outputs(outputs, model.cfg.num_queries)
        costs, kept = criterion.collect_costs(obj, targets, draw, match_points)
        if assignments is None:
            assignments = batched_hungarian(costs)
        losses = criterion.losses_from_assignments(kept, assignments, targets, draw)
        total = sum(losses.values())
        total.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grad_norm = state.optimizer.step()
        metrics = {"loss_total": total.detach(), **{k: v.detach() for k, v in losses.items()},
                   "grad_norm": grad_norm, "assignments": assignments}
        return state, metrics

    return train_step
