"""Grounding, spatial-prompt and VLP (caption, captioning, retrieval)
training losses, PyTorch port of ``iuvl_tpu/losses/grounding.py``.

- Grounding: the grounding queries' caption embeddings against the
  phrases' pooled embeddings give a similarity; with point-sampled mask
  BCE and dice it is the cost of a Hungarian match
  (:func:`grounding_cost`); the matched masks then get point-sampled BCE
  and dice, and a text-to-image CE whose targets share credit across
  duplicate phrases (:func:`grounding_losses`).
- Spatial prompts: point-sampled BCE and dice of each prompt slot's mask
  against the instance it was drawn from (the assignment is the
  identity).
- Caption: the seg-matched queries contrast against their class-name
  embeddings, the other queries are similarity-matched to the caption's
  phrases and contrast against those (:func:`caption_loss`).
- Captioning: teacher-forced next-token CE against the token table;
  retrieval: symmetric InfoNCE of the class query and the pooled caption.

Random points come from a :data:`~iuvl_tpu_torch.ops.point_sample.Draw`:
``{name}/pts`` (the cost's shared points, ``num_points // 4`` an image),
``{name}/over`` and ``{name}/rand`` (the importance sample); JAX splits
its key the same way (``grounding.py:72-75``, ``:109-123``). The predicted
masks are differentiated through :func:`point_sample`'s gather, as JAX
differentiates through XLA's gather (not the tap scatter, B12).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.point_sample import Draw, point_sample, point_sample_shared, uncertain_point_coords
from .language import clamped_scale, contrastive_loss, ql_multi_contrastive_loss
from .matcher import BIG_COST, hungarian_match, pairwise_dice, pairwise_sigmoid_ce


@dataclasses.dataclass
class GroundingTargets:
    masks: torch.Tensor         # (B, G, H, W) float {0, 1}
    class_embs: torch.Tensor    # (B, G, D) pooled phrase embeddings
    group_matrix: torch.Tensor  # (B, G, G) 1 iff phrases identical
    valid: torch.Tensor         # (B, G) bool
    task_weight: torch.Tensor   # (B,) 2.0 for text grounding, 0.5 for class names


@dataclasses.dataclass(frozen=True)
class GroundingConfig:
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    cost_class: float = 2.0
    cost_mask: float = 5.0
    cost_dice: float = 5.0


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-7)


def _similarity(pred_texts, embs, logit_scale) -> torch.Tensor:
    """(B, Q, G) scaled cosine similarity of queries to phrases."""
    return clamped_scale(logit_scale) * torch.einsum("bqd,bgd->bqg", _unit(pred_texts),
                                                     _unit(embs))


def _mask_losses(src, tgt, valid, draw: Draw, name: str, num_points: int,
                 oversample_ratio: float, importance_sample_ratio: float):
    """Point-sampled BCE and dice of (N, H, W) logits against (N, h, w)
    binary masks at the uncertain points of ``src``, averaged over the
    ``valid`` rows."""
    coords = uncertain_point_coords(src.detach(), num_points, draw, name, oversample_ratio,
                                    importance_sample_ratio)
    pl_ = point_sample(src, coords)
    tl = point_sample(tgt, coords)
    v = valid.float()
    num = torch.clamp(v.sum(), min=1.0)
    bce = ((F.softplus(pl_) - pl_ * tl).mean(-1) * v).sum() / num
    probs = torch.sigmoid(pl_)
    dice = (1.0 - (2.0 * (probs * tl).sum(-1) + 1.0)
            / (probs.sum(-1) + tl.sum(-1) + 1.0)) * v
    return bce, dice.sum() / num


@torch.no_grad()
def grounding_cost(draw: Draw, name: str, pred_gmasks, pred_gtexts, targets: GroundingTargets,
                   logit_scale, cfg: GroundingConfig = GroundingConfig()) -> torch.Tensor:
    """(B, Q, G) matching cost of the grounding queries' (B, Q, H, W) masks
    and (B, Q, D) caption embeddings against the phrases, over the shared
    points ``draw(name + '/pts')``; invalid phrases cost BIG_COST."""
    b = pred_gmasks.shape[0]
    sim = _similarity(pred_gtexts, targets.class_embs, logit_scale)
    coords = draw(f"{name}/pts", (b, cfg.num_points // 4, 2))
    pm = point_sample_shared(pred_gmasks.float(), coords)
    tm = point_sample_shared(targets.masks.float(), coords)
    cost = (cfg.cost_class * -torch.softmax(sim, dim=1)
            + cfg.cost_mask * pairwise_sigmoid_ce(pm, tm)
            + cfg.cost_dice * pairwise_dice(pm, tm))
    big = torch.full_like(cost, BIG_COST)
    cost = torch.where(torch.isfinite(cost), cost, big)
    return torch.where(targets.valid[:, None, :], cost, big)


def grounding_losses(draw: Draw, name: str, pred_gmasks, pred_gtexts,
                     targets: GroundingTargets, logit_scale,
                     cfg: GroundingConfig = GroundingConfig(), assigned=None) -> dict:
    """The grounding losses of one layer (``loss_grounding_{bce,dice,ce}_0``);
    ``assigned`` (B, G) is the query matched to each phrase, solved here
    from :func:`grounding_cost` (with the same ``draw`` and ``name``) when
    not given."""
    b, q = pred_gmasks.shape[:2]
    g = targets.masks.shape[1]
    if assigned is None:
        assigned = hungarian_match(grounding_cost(draw, name, pred_gmasks, pred_gtexts, targets,
                                                  logit_scale, cfg))
    sim = _similarity(pred_gtexts, targets.class_embs, logit_scale)
    h, w = pred_gmasks.shape[2:]
    src = torch.gather(pred_gmasks, 1, assigned[:, :, None, None].expand(-1, -1, h, w))
    bce, dice = _mask_losses(
        src.reshape(b * g, h, w).float(),
        targets.masks.reshape(b * g, *targets.masks.shape[2:]).float(),
        targets.valid.reshape(b * g), draw, name, cfg.num_points, cfg.oversample_ratio,
        cfg.importance_sample_ratio)
    # The text-to-image CE: the target of phrase g is its matched query,
    # its credit spread over the phrase's duplicates.
    onehot = F.one_hot(assigned, q).float().transpose(1, 2)  # (B, Q, G)
    gm = targets.group_matrix / torch.clamp(targets.group_matrix.sum(-1, keepdim=True), min=1.0)
    gt_logit = torch.einsum("bqg,bgh->bqh", onehot, gm)
    logp = torch.log_softmax(sim.transpose(1, 2).float(), dim=-1)  # (B, G, Q)
    ce = -(gt_logit.transpose(1, 2) * logp).sum(-1)
    wvalid = targets.valid.float()
    ce = (ce * wvalid).sum(-1) / torch.clamp(wvalid.sum(-1), min=1.0)
    return {"loss_grounding_bce_0": bce, "loss_grounding_dice_0": dice,
            "loss_grounding_ce_0": (ce * targets.task_weight).mean()}


def spatial_losses(draw: Draw, name: str, pred_masks, gt_masks, valid,
                   num_points: int = 12544, oversample_ratio: float = 3.0,
                   importance_sample_ratio: float = 0.75) -> dict:
    """Point-sampled BCE and dice of the (B, P, H, W) prompt-slot logits
    against the (B, P, h, w) masks their prompts were drawn from."""
    b, p = pred_masks.shape[:2]
    bce, dice = _mask_losses(pred_masks.reshape(b * p, *pred_masks.shape[2:]).float(),
                             gt_masks.reshape(b * p, *gt_masks.shape[2:]).float(),
                             valid.reshape(b * p), draw, name, num_points, oversample_ratio,
                             importance_sample_ratio)
    return {"loss_spatial_bce_0": bce, "loss_spatial_dice_0": dice}


@torch.no_grad()
def caption_phrase_cost(pred_captions, assigned, tgt_valid, phrase_embs, phrase_valid,
                        logit_scale) -> torch.Tensor:
    """(B, Q, P) cost of matching the queries to the caption's phrases by
    similarity alone: the queries matched to valid gt instances and the
    invalid phrases cost BIG_COST."""
    b, q = pred_captions.shape[:2]
    sim = _similarity(pred_captions, phrase_embs, logit_scale)
    matched = torch.zeros((b, q), dtype=torch.bool, device=sim.device)
    matched[torch.arange(b, device=sim.device)[:, None], assigned] = tgt_valid.bool()
    cost = -sim + torch.where(matched[:, :, None], BIG_COST, 0.0)
    return torch.where(phrase_valid[:, None, :], cost, torch.full_like(cost, BIG_COST))


def caption_loss(pred_captions, assigned, tgt_labels, tgt_valid, class_embeddings, phrase_embs,
                 phrase_valid, phrase_groups, logit_scale, assigned_p=None) -> torch.Tensor:
    """Query-caption contrastive loss of one layer: the queries matched to
    gt instances (``assigned`` (B, T), the seg matching) against their
    class embeddings ((K, D) ``class_embeddings``), the queries matched to
    the phrases (``assigned_p`` (B, P); solved here from
    :func:`caption_phrase_cost` when not given) against the (B, P, D)
    phrase embeddings, per image, duplicate phrases sharing credit."""
    b, q, d = pred_captions.shape
    t, p = tgt_labels.shape[1], phrase_embs.shape[1]
    if assigned_p is None:
        assigned_p = hungarian_match(caption_phrase_cost(pred_captions, assigned, tgt_valid,
                                                         phrase_embs, phrase_valid, logit_scale))
    v_matched = torch.gather(pred_captions, 1, assigned[..., None].expand(-1, -1, d))
    v_phrase = torch.gather(pred_captions, 1, assigned_p[..., None].expand(-1, -1, d))
    t_matched = class_embeddings[tgt_labels.long()]
    v_all = torch.cat([v_matched, v_phrase], dim=1).reshape(b * (t + p), d)
    t_all = torch.cat([t_matched, phrase_embs], dim=1).reshape(b * (t + p), d)
    valid_all = torch.cat([tgt_valid.bool(), phrase_valid.bool()], dim=1).reshape(-1)
    group = torch.zeros((b, t + p, t + p), device=pred_captions.device)
    group[:, :t, :t] = torch.eye(t, device=group.device)
    group[:, t:, t:] = phrase_groups
    return ql_multi_contrastive_loss(_unit(v_all), _unit(t_all), torch.block_diag(*group),
                                     logit_scale, valid=valid_all)


def captioning_loss(pred_captionings, token_embedding, target_ids, target_mask) -> torch.Tensor:
    """Teacher-forced next-token CE of the (B, T, D) caption slots against
    the (V, D) token table, over the real tokens of ``target_mask``."""
    logits = pred_captionings[:, :-1].float() @ token_embedding.float().t()
    nll = -torch.gather(torch.log_softmax(logits, dim=-1), 2,
                        target_ids[:, 1:, None].long())[..., 0]
    msk = target_mask[:, 1:].float()
    return (nll * msk).sum() / (msk.sum() + 1.0)


def retrieval_loss(class_query_emb, caption_emb, logit_scale) -> torch.Tensor:
    """Image-text contrastive loss of the (B, D) class-query embeddings and
    the (B, D) pooled caption embeddings."""
    return contrastive_loss(_unit(class_query_emb), _unit(caption_emb), logit_scale)
