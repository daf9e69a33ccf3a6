"""The train steps, PyTorch port of ``iuvl_tpu/train/train_step.py``:
``make_train_step`` (the seg stream) and ``make_joint_train_step`` (the
step-1 objective: the seg stream with the caption and grounding losses,
the spatial-prompt stream and the VLP stream).

One step: the forwards, the matchings (the host Hungarian solver, every
matching of the step in one call; the caption loss's phrase matchings,
which read the seg matching, in a second), the weighted losses, one backward and one optimizer
update. PyTorch runs it eagerly; the JAX package jits the same program.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from ..losses.criterion import SegCriterion, SegTargets
from ..losses.grounding import (GroundingConfig, GroundingTargets, caption_loss,
                                caption_phrase_cost, captioning_loss, grounding_cost,
                                grounding_losses, retrieval_loss, spatial_losses)
from ..losses.matcher import batched_hungarian, compute_match_cost
from ..ops.point_sample import Draw, generator_draws, given_draws
from .optimizer import Optimizer


@dataclasses.dataclass
class TrainState:
    """The optimizer over the model's parameters, which it updates in
    place; ``step`` is the number of updates made (optax's count)."""

    optimizer: Optimizer

    @property
    def step(self) -> int:
        return self.optimizer.count


def split_seg_outputs(outputs: dict, num_queries: int, grounding: bool = False):
    """(obj, grd): the object-query block (the first ``num_queries - 1``
    queries) of the head outputs and of every aux layer, and with
    ``grounding`` the duplicated block after the class query, else None
    (reference forward_seg:352-380). Each block keeps its layer's caption
    embeddings where the layer has them."""
    nq = num_queries

    def block(o, lo, hi):
        out = {"pred_logits": o["pred_logits"][:, lo:hi], "pred_masks": o["pred_masks"][:, lo:hi]}
        if o.get("pred_captions") is not None:
            out["pred_captions"] = o["pred_captions"][:, lo:hi]
        return out

    obj = block(outputs, 0, nq - 1)
    obj["aux_outputs"] = [block(a, 0, nq - 1) for a in outputs["aux_outputs"]]
    if not grounding:
        return obj, None
    grd = block(outputs, nq, 2 * nq - 1)
    grd["aux_outputs"] = [block(a, nq, 2 * nq - 1) for a in outputs["aux_outputs"]]
    return obj, grd


def _draw_of(generator, device) -> Draw:
    """A :data:`Draw` from a mapping of given draws, a ``torch.Generator``
    or a Draw itself."""
    if isinstance(generator, Mapping):
        return given_draws(generator)
    if isinstance(generator, torch.Generator):
        return generator_draws(generator, device)
    return generator


def _update(model, state: TrainState, total) -> torch.Tensor:
    """One backward and one optimizer update; every parameter takes part,
    as in the JAX step: one the forward does not read gets a zero
    gradient, so weight decay still reaches it. Returns the grad norm."""
    total.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return state.optimizer.step()


def make_train_step(model, criterion: SegCriterion, match_points: int = 12544) -> Callable:
    """Returns ``train_step(state, images, text_embeddings, targets,
    generator, assignments=None) -> (state, metrics)``: the seg stream alone,
    :func:`make_joint_train_step` without extras or VLP.

    ``generator``: a ``torch.Generator`` for the criterion's random points,
    or a mapping of given draws (``ops.point_sample.given_draws``).
    ``assignments``: the kept layers' (B, T) assignments, to skip the
    matcher (a caller that holds several paths to one matching); the
    metrics carry the ones used. Every parameter takes part in the update,
    as in the JAX step: one that the seg forward does not read gets a zero
    gradient, so weight decay still reaches it."""
    joint = make_joint_train_step(model, criterion, match_points)

    def train_step(state: TrainState, images, text_embeddings, targets: SegTargets,
                   generator, assignments=None):
        given = None if assignments is None else {"criterion": assignments, "caption": [],
                                                   "grounding": [], "phrase": []}
        state, metrics = joint(state, images, text_embeddings, targets, None, None, generator,
                               assignments=given)
        metrics["assignments"] = metrics["assignments"]["criterion"]
        return state, metrics

    return train_step


def spatial_stream_losses(logits, extras: dict, draw: Draw, match_points: int = 12544,
                          spatial_weight: float = 5.0) -> dict:
    """The spatial-prompt stream's weighted losses: its (B, S, H/4, W/4)
    mask logits (:meth:`SysLearner.spatial_decode`) against the
    ``spatial_masks`` / ``spatial_valid`` of the step-1 extras (draws
    ``spatial/over`` and ``spatial/rand``)."""
    return {k: spatial_weight * v for k, v in spatial_losses(
        draw, "spatial", logits, extras["spatial_masks"], extras["spatial_valid"],
        num_points=match_points).items()}


def vlp_stream_losses(out: dict, vlp_batch: dict, captioning_weight: float = 2.0,
                      retrieval_weight: float = 2.0, backbone_weight: float = 8.0) -> dict:
    """The VLP stream's weighted losses from :meth:`SysLearner.forward_vlp_train`'s
    outputs on ``vlp_batch`` (``{images, caption_ids, caption_mask}``):
    captioning, the decoder's retrieval and, with ``retrieval_ensemble``,
    the backbone's."""
    losses = {"loss_captioning_0": captioning_weight * captioning_loss(
        out["pred_captionings"], out["token_table"], vlp_batch["caption_ids"],
        vlp_batch["caption_mask"]),
        "loss_retrieval_decoder_0": retrieval_weight * retrieval_loss(
            out["pred_captions"][:, -1], out["caption_class_emb"], out["logit_scale"])}
    if "backbone_emb" in out:
        losses["loss_retrieval_backbone_0"] = backbone_weight * retrieval_loss(
            out["backbone_emb"], out["caption_class_emb"], out["logit_scale"])
    return losses


def make_joint_train_step(model, criterion: SegCriterion, match_points: int = 12544,
                          captioning_weight: float = 2.0, retrieval_weight: float = 2.0,
                          backbone_weight: float = 8.0, spatial_weight: float = 5.0,
                          language_loss_layers: int = 10, loss_only: bool = False) -> Callable:
    """The step-1 joint step (JAX ``make_joint_train_step``; the optimizer
    rides in the state, as in :func:`make_train_step`). Returns
    ``train_step(state, seg_images, text_embeddings, targets, vlp_batch,
    seg_extras, generator, assignments=None) -> (state, metrics)``; with
    ``loss_only`` ``losses(seg_images, text_embeddings, targets, vlp_batch,
    seg_extras, generator, assignments=None) -> metrics`` without backward
    or update (the losses keep their graph where autograd records).

    - ``text_embeddings``: (K, D) class embeddings, or ``{ids, mask}`` (K,
      L) token ids that the text tower embeds in the step (live text: the
      tower trains through the class losses).
    - ``seg_extras`` (None members are switches): ``phrase_ids`` /
      ``phrase_mask`` (B, P, L) or ``phrase_embs`` (B, P, D), with
      ``phrase_valid``, ``phrase_groups`` (B, P, P): the per-layer
      ``loss_caption``; ``grounding_ids`` / ``grounding_mask`` (B, G, L)
      (embedded in the step: every token a grounding query, the pooled
      embedding the phrase's) or ``grounding_tokens`` / ``grounding_valid``
      / ``grounding_class_embs``, with ``grounding_masks`` (B, G, h, w),
      ``grounding_groups``, ``grounding_target_valid`` (B, G) and
      ``grounding_task_weight`` (B,): the per-layer grounding losses;
      ``spatial_points`` (B, S, 2), ``spatial_labels``, ``spatial_masks``
      (B, S, h, w), ``spatial_valid``: the spatial-prompt stream.
    - ``vlp_batch``: None or ``{images, caption_ids, caption_mask}``.
    - ``generator``: a ``torch.Generator``, a mapping of given draws or a
      :data:`Draw`.
    - ``assignments``: every matching of the step, as the metrics return
      them: ``{"criterion", "caption", "grounding", "phrase"}``, lists of
      (B, T) per kept layer, so that several paths can share one matching.

    The seg and spatial streams read one encode of ``seg_images`` (SAM's
    embedding and the pixel decoder's products); autograd sums their
    gradients, as JAX's step does after XLA merges its two identical
    encodes. Loss names are JAX's: suffix ``_0`` for the last layer,
    ``_{i + 1}`` for aux layer i; the caption and grounding losses on the
    last ``language_loss_layers`` layers, the criterion's on its
    ``top_mask_layers``.

    Draws, by name, beside JAX's split chain (``train_step.py:175-267``,
    ``grounding.py:72-75``, ``:109-123``; ``rng`` is the step's key, and
    each stream's chain starts from it):

    - criterion, layer i of all (JAX ``rng, r_match, r_pts = split(rng,
      3)`` a layer): ``layer{i}/match`` (B, match_points, 2) from
      ``r_match``; ``layer{i}/over`` and ``layer{i}/rand`` from the two
      halves of ``split(r_pts)``;
    - caption, each language layer i in order (``rng, r_cap, r_m =
      split(rng, 3)``): ``caption{i}/match`` (B, match_points, 2) from
      ``r_m``;
    - grounding, each language layer i after them (``rng, r_g =
      split(rng)``; then ``_, r_pts, r_loss = split(r_g, 3)``):
      ``grounding{i}/pts`` (B, match_points // 4, 2) from ``r_pts``,
      ``grounding{i}/over`` and ``/rand`` from ``split(r_loss)``;
    - spatial, last (``rng, r_sp = split(rng)``): ``spatial/over`` and
      ``spatial/rand`` from ``split(r_sp)``.
    """
    gcfg = GroundingConfig(num_points=match_points)
    nq = model.cfg.num_queries

    def embed_text(text_embeddings, extras: dict):
        """The step's live text embeddings, through the text tower."""
        if isinstance(text_embeddings, Mapping):
            text_embeddings = model.encode_text_embeddings(text_embeddings["ids"],
                                                           text_embeddings["mask"])
        if "phrase_ids" in extras:
            pid, pmask = extras["phrase_ids"], extras["phrase_mask"]
            b, p, n = pid.shape
            _, cls = model.encode_text_tokens(pid.reshape(b * p, n), pmask.reshape(b * p, n))
            extras["phrase_embs"] = cls.reshape(b, p, -1)
        if "grounding_ids" in extras:
            gid, gmask = extras["grounding_ids"], extras["grounding_mask"]
            b, g, n = gid.shape
            tok, cls = model.encode_text_tokens(gid.reshape(b * g, n), gmask.reshape(b * g, n))
            c = tok.shape[-1]
            # Every token a grounding query; grounding_valid is the tokens'
            # validity, grounding_target_valid the phrases'.
            extras["grounding_tokens"] = tok.reshape(b, g * n, c)
            extras["grounding_valid"] = gmask.reshape(b, g * n).bool()
            extras["grounding_class_embs"] = cls.reshape(b, g, c)
        return text_embeddings

    def losses_of(seg_images, text_embeddings, targets: SegTargets, vlp_batch, seg_extras,
                  draw: Draw, assignments):
        extras = dict(seg_extras or {})
        text_embeddings = embed_text(text_embeddings, extras)
        logit_scale = model.lang_encoder.logit_scale
        grounding = "grounding_tokens" in extras
        spatial = "spatial_points" in extras
        if spatial:
            encoded = model.encode_interactive(seg_images)
            mask_features, multi_scale = encoded[1:]
        else:
            _, fpn = model.encode_image(seg_images, return_embedding=False)
            mask_features, multi_scale = model.pixel_decoder(fpn)
        outputs = model.seg_head(mask_features, multi_scale, text_embeddings,
                                 extras.get("grounding_tokens"), extras.get("grounding_valid"))
        obj, grd = split_seg_outputs(outputs, nq, grounding)
        layers = obj["aux_outputs"] + [obj]  # the object queries of every layer
        n_layers = len(layers)
        lang_ids = range(max(0, n_layers - language_loss_layers), n_layers)

        def suffix(i):
            return "_0" if i == n_layers - 1 else f"_{i + 1}"

        crit_costs, kept = criterion.collect_costs(obj, targets, draw, match_points)
        costs = {"criterion": crit_costs, "caption": [], "grounding": []}
        cap_ids = list(lang_ids) if "phrase_embs" in extras else []
        for i in cap_ids:
            o = layers[i]
            costs["caption"].append(compute_match_cost(
                draw, f"caption{i}/match", o["pred_logits"].detach(), o["pred_masks"].detach(),
                targets.labels, targets.masks, targets.valid, num_points=match_points))
        gt, grd_layers = None, grd["aux_outputs"] + [grd] if grounding else []
        grd_ids = list(lang_ids) if grounding and "grounding_masks" in extras else []
        if grd_ids:
            gt = GroundingTargets(
                masks=extras["grounding_masks"], class_embs=extras["grounding_class_embs"],
                group_matrix=extras["grounding_groups"],
                valid=extras["grounding_target_valid"].bool(),
                task_weight=extras["grounding_task_weight"])
        for i in grd_ids:
            o = grd_layers[i]
            costs["grounding"].append(grounding_cost(draw, f"grounding{i}", o["pred_masks"],
                                                     o["pred_captions"], gt, logit_scale, gcfg))
        if assignments is None:
            order = ("criterion", "caption", "grounding")
            solved = iter(batched_hungarian([c for k in order for c in costs[k]]))
            assignments = {k: [next(solved) for _ in costs[k]] for k in order}
            # The caption loss's own matching of the other queries to the
            # phrases reads the seg matching: a second call.
            assignments["phrase"] = batched_hungarian([caption_phrase_cost(
                layers[i]["pred_captions"], a, targets.valid,
                extras["phrase_embs"], extras["phrase_valid"], logit_scale)
                for i, a in zip(cap_ids, assignments["caption"])]) if cap_ids else []

        losses = criterion.losses_from_assignments(kept, assignments["criterion"], targets, draw)
        for i, a, a_p in zip(cap_ids, assignments["caption"], assignments["phrase"]):
            losses[f"loss_caption{suffix(i)}"] = caption_loss(
                layers[i]["pred_captions"], a, targets.labels, targets.valid,
                text_embeddings, extras["phrase_embs"], extras["phrase_valid"],
                extras["phrase_groups"], logit_scale, assigned_p=a_p)
        for i, a in zip(grd_ids, assignments["grounding"]):
            o = grd_layers[i]
            g_losses = grounding_losses(draw, f"grounding{i}", o["pred_masks"],
                                        o["pred_captions"], gt, logit_scale, gcfg, assigned=a)
            losses.update({k.replace("_0", suffix(i)): v for k, v in g_losses.items()})
        if spatial:
            logits = model.spatial_decode(*encoded, extras["spatial_points"],
                                          extras["spatial_labels"])
            losses.update(spatial_stream_losses(logits, extras, draw, match_points,
                                                spatial_weight))
        if vlp_batch is not None:
            out = model.forward_vlp_train(vlp_batch["images"], vlp_batch["caption_ids"],
                                          vlp_batch["caption_mask"])
            losses.update(vlp_stream_losses(out, vlp_batch, captioning_weight,
                                            retrieval_weight, backbone_weight))
        return losses, assignments

    def losses(seg_images, text_embeddings, targets: SegTargets, vlp_batch, seg_extras,
               generator, assignments=None) -> dict:
        out, assignments = losses_of(seg_images, text_embeddings, targets, vlp_batch,
                                     seg_extras, _draw_of(generator, seg_images.device),
                                     assignments)
        return {"loss_total": sum(out.values()), **out, "assignments": assignments}

    if loss_only:
        return losses

    def train_step(state: TrainState, seg_images, text_embeddings, targets: SegTargets,
                   vlp_batch, seg_extras, generator, assignments=None):
        for p in model.parameters():
            p.grad = None
        out, assignments = losses_of(seg_images, text_embeddings, targets, vlp_batch,
                                     seg_extras, _draw_of(generator, seg_images.device),
                                     assignments)
        total = sum(out.values())
        grad_norm = _update(model, state, total)
        metrics = {"loss_total": total.detach(), **{k: v.detach() for k, v in out.items()},
                   "grad_norm": grad_norm, "assignments": assignments}
        return state, metrics

    return train_step
