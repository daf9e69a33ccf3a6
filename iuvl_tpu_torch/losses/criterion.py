"""Set criterion of the seg stream, PyTorch port of
``iuvl_tpu/losses/criterion.py``.

Class cross-entropy with a no-object weight, and point-sampled sigmoid-CE
and dice on the matched masks (importance sampling of uncertain points),
for the final layer and the aux layers (``top_mask_layers``). Two phases,
as in JAX, so that a caller can solve the matchings itself:
:meth:`SegCriterion.collect_costs` (per kept layer, no gradient), then
:meth:`SegCriterion.losses_from_assignments`. Random points come from a
:data:`~iuvl_tpu_torch.ops.point_sample.Draw`, named per layer
(``layer{i}/match``, ``layer{i}/over``, ``layer{i}/rand``). The box losses
(DETECTION) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.point_sample import (Draw, point_sample, point_sample_trainable,
                                uncertain_point_coords)
from .matcher import batched_hungarian, compute_match_cost


@dataclasses.dataclass
class SegTargets:
    labels: torch.Tensor  # (B, T) class ids
    masks: torch.Tensor   # (B, T, H, W) float {0, 1}
    valid: torch.Tensor   # (B, T) bool


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    num_classes: int  # K - 1: the no-object column is index num_classes
    eos_coef: float = 0.1
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    top_mask_layers: int = 10


class SegCriterion:
    """``impl``: ``'auto'`` runs the point-sample backward through the tap
    scatter kernel (B12) on CUDA tensors, ``'plain'`` through its plain
    version (the model's ``attn_impl`` counterpart)."""

    def __init__(self, cfg: CriterionConfig, impl: str = "auto"):
        if impl not in ("auto", "plain"):
            raise ValueError(f"SegCriterion impl {impl!r} not in ('auto', 'plain')")
        self.cfg, self.impl = cfg, impl

    def loss_labels(self, pred_logits, targets: SegTargets, assigned):
        c = self.cfg
        b, q, _ = pred_logits.shape
        no_object = c.num_classes
        tc = torch.full((b, q), no_object, dtype=torch.long, device=pred_logits.device)
        values = torch.where(targets.valid, targets.labels.long(),
                             torch.full_like(targets.labels.long(), no_object))
        tc[torch.arange(b, device=tc.device)[:, None], assigned] = values
        logp = torch.log_softmax(pred_logits.float(), dim=-1)
        nll = -torch.gather(logp, 2, tc[..., None])[..., 0]
        w = torch.where(tc == no_object, c.eos_coef, 1.0)
        return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)

    def loss_masks(self, draw: Draw, name: str, pred_masks, targets: SegTargets, assigned,
                   num_masks):
        c = self.cfg
        b, _, h, w = pred_masks.shape
        t = targets.labels.shape[1]
        src = torch.gather(pred_masks, 1, assigned[:, :, None, None].expand(-1, -1, h, w))
        src = src.reshape(b * t, h, w).float()
        coords = uncertain_point_coords(src.detach(), c.num_points, draw, name,
                                        c.oversample_ratio, c.importance_sample_ratio)
        point_logits = point_sample_trainable(src, coords, impl=self.impl)
        tgt = targets.masks.reshape(b * t, *targets.masks.shape[2:]).float()
        point_labels = point_sample(tgt, coords, store_dtype=torch.bfloat16)
        valid = targets.valid.reshape(b * t).float()
        bce = (torch.nn.functional.softplus(point_logits)
               - point_logits * point_labels).mean(-1)
        loss_bce = (bce * valid).sum() / num_masks
        probs = torch.sigmoid(point_logits)
        numerator = 2.0 * (probs * point_labels).sum(-1)
        denominator = probs.sum(-1) + point_labels.sum(-1)
        dice = 1.0 - (numerator + 1.0) / (denominator + 1.0)
        return loss_bce, (dice * valid).sum() / num_masks

    def collect_costs(self, outputs: dict, targets: SegTargets, draw: Draw,
                      match_points: int = 12544):
        """Phase 1: the (B, Q, T) matching cost of every kept layer (the
        final layer always; ``top_mask_layers`` trims the earliest aux
        layers), and the kept layers' records."""
        c = self.cfg
        layers = list(outputs["aux_outputs"]) + [
            {k: outputs.get(k) for k in ("pred_logits", "pred_masks")}]
        n_layers = len(layers)
        costs, kept = [], []
        for layer_id, out in enumerate(layers):
            if layer_id < max(0, n_layers - c.top_mask_layers):
                continue
            costs.append(compute_match_cost(
                draw, f"layer{layer_id}/match", out["pred_logits"].detach(),
                out["pred_masks"].detach(), targets.labels, targets.masks, targets.valid,
                num_points=match_points, cost_class=c.class_weight, cost_mask=c.mask_weight,
                cost_dice=c.dice_weight))
            kept.append((layer_id, out, n_layers))
        return costs, kept

    def losses_from_assignments(self, kept, assignments, targets: SegTargets,
                                draw: Draw) -> dict[str, Any]:
        """Phase 2: the weighted losses of the kept layers."""
        c = self.cfg
        num_masks = torch.clamp(targets.valid.sum().float(), min=1.0)
        losses = {}
        for (layer_id, out, n_layers), assigned in zip(kept, assignments):
            suffix = "_0" if layer_id == n_layers - 1 else f"_{layer_id + 1}"
            ce = self.loss_labels(out["pred_logits"], targets, assigned)
            bce, dice = self.loss_masks(draw, f"layer{layer_id}", out["pred_masks"], targets,
                                        assigned, num_masks)
            losses[f"loss_mask_ce{suffix}"] = c.class_weight * ce
            losses[f"loss_mask_bce{suffix}"] = c.mask_weight * bce
            losses[f"loss_mask_dice{suffix}"] = c.dice_weight * dice
        return losses

    def __call__(self, outputs: dict, targets: SegTargets, draw: Draw,
                 match_points: int = 12544) -> dict[str, Any]:
        costs, kept = self.collect_costs(outputs, targets, draw, match_points)
        return self.losses_from_assignments(kept, batched_hungarian(costs), targets, draw)
