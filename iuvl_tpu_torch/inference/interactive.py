"""The interactive click-refinement loop, PyTorch port of
``iuvl_tpu/inference/interactive.py``.

Protocol (the reference's evaluate_interactive): up to MAX_CLICKS rounds;
each round decodes every target's prompt from the cached image products,
resizes the mask logits bicubically to the gt resolution, scores the IoU
and draws the next click uniformly from the false-negative pixels, adding
it only while the IoU is below STOP_IOU. Clicks go through SAM's prompt
encoder and mask decoder into the unified decoder
(``SysLearner.decode_interactive``); ``unified=False`` scores SAM's own
masks (the ablation baseline).

JAX runs the rounds as one ``lax.scan``; here they are a Python loop over
the cached embedding and pixel-decoder products, on the model's device.
The click draw takes an explicit ``torch.Generator`` (JAX's categorical
draw over a PRNG key gives other clicks for the same seed), and the loop
takes the sampler as an argument so that a caller can supply the clicks.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.resize import resize_axis

STOP_IOU = 0.925  # reference xdecoder_model.py:889
MAX_CLICKS = 20  # reference :723


def mask_iou(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool-ish -> (N,) IoU, ``inter / (union + 1e-8)`` in fp64,
    as the NoC fixture (scripts/bench_noc.py) computes it. JAX's
    ``mask_iou`` divides in fp32, where the 1e-8 vanishes: an IoU of
    exactly a threshold (170 / 200 = 0.85) reaches it there and falls short
    of it here (ROADMAP.md Queue C)."""
    p, g = pred.bool(), gt.bool()
    inter = (p & g).sum((-2, -1)).double()
    union = (p | g).sum((-2, -1)).double()
    return inter / (union + 1e-8)


def sample_fn_click(generator, gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """One click per target, uniform over its false-negative pixels (the
    whole gt where there are none, every pixel where the gt is empty too).
    gt, pred (N, H, W) bool; ``generator`` a ``torch.Generator`` on their
    device (or None). Returns (N, 2) fp32 xy."""
    n, _, w = gt.shape
    fn = gt & ~pred
    fn = torch.where(fn.flatten(1).any(-1)[:, None, None], fn, gt)
    weights = fn.flatten(1).float()
    weights[weights.sum(-1) == 0] = 1.0
    idx = torch.multinomial(weights, 1, generator=generator)[:, 0]
    return torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)


def _bicubic(logits: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, h', w') -> (N, h, w) as ``jax.image.resize(..., 'bicubic')``."""
    return resize_axis(resize_axis(logits.float(), 1, h, "cubic"), 2, w, "cubic")


def make_interactive_loop(model, max_clicks: int = MAX_CLICKS, stop_iou: float = STOP_IOU,
                          mask_index: int = 0, unified: bool = True,
                          sample_fn=sample_fn_click):
    """Returns ``loop(sam_embedding, mask_features, multi_scale, gt_masks,
    first_clicks, generator=None) -> (ious (rounds, N), final_masks (N, H,
    W))`` over a ``SysLearner`` (``model``):

    - ``sam_embedding`` (1, 64, 64, 256), ``mask_features`` and
      ``multi_scale`` the cached products of ``encode_interactive`` (batch
      1; with ``unified=False`` only the embedding is read);
    - ``gt_masks`` (N, H, W) bool at the model's input resolution;
    - ``first_clicks`` (N, 2) xy in input space;
    - ``generator`` the click draws' generator, handed to ``sample_fn``.

    Every round decodes MAX_CLICKS point slots, the unused ones padded
    with label -1."""

    @torch.no_grad()
    def loop(sam_embedding, mask_features, multi_scale, gt_masks, first_clicks,
             generator=None):
        n, gh, gw = gt_masks.shape
        dev = gt_masks.device
        points = torch.zeros((n, max_clicks, 2), dtype=torch.float32, device=dev)
        labels = torch.full((n, max_clicks), -1, dtype=torch.int32, device=dev)
        points[:, 0] = first_clicks.float()
        labels[:, 0] = 1
        gt = gt_masks.bool()
        ious_all, pred = [], None
        for rnd in range(max_clicks):
            if unified:
                logits = model.decode_interactive(sam_embedding, mask_features, multi_scale,
                                                  points=points, labels=labels)
            else:
                out = model.decode_prompts(sam_embedding, points=points, labels=labels,
                                           return_upscaled=False)
                logits = out["masks"][:, mask_index]
            pred = _bicubic(logits, gh, gw) > 0
            ious = mask_iou(pred, gt)
            click = sample_fn(generator, gt, pred)
            keep = ious < stop_iou
            slot = min(rnd + 1, max_clicks - 1)
            points[:, slot] = torch.where(keep[:, None], click.to(dev), points[:, slot])
            labels[:, slot] = torch.where(keep, 1, labels[:, slot])
            ious_all.append(ious)
        return torch.stack(ious_all), pred

    return loop


@torch.no_grad()
def single_shot_eval(model, sam_embedding, gt_masks, prompt_type: str, prompt_masks=None,
                     boxes=None, num_points: int = 8, seed: int = 0, mask_index: int = 0):
    """One decode of box or stroke prompts from the cached embedding (the
    reference's box / circle / scribble / polygon modes): boxes (N, 4) xyxy
    stay boxes; a stroke mask becomes up to ``num_points`` positive points
    drawn with numpy's ``RandomState(seed)``, as in JAX. gt_masks (N, H, W)
    bool (numpy or tensor). Returns (ious (N,), pred_masks (N, H, W)) on
    the model's device."""
    dev = sam_embedding.device
    gt = torch.as_tensor(np.asarray(gt_masks), device=dev).bool()
    n, gh, gw = gt.shape
    if prompt_type == "box":
        assert boxes is not None
        out = model.decode_prompts(sam_embedding, boxes=torch.as_tensor(
            np.asarray(boxes), dtype=torch.float32, device=dev), return_upscaled=False)
    else:
        assert prompt_masks is not None
        pts = np.zeros((n, num_points, 2), np.float32)
        labs = -np.ones((n, num_points), np.int32)
        rs = np.random.RandomState(seed)
        for i in range(n):
            ys, xs = np.nonzero(np.asarray(prompt_masks[i]))
            if len(ys) == 0:
                continue
            take = rs.choice(len(ys), size=min(num_points, len(ys)), replace=False)
            pts[i, :len(take)] = np.stack([xs[take], ys[take]], -1)
            labs[i, :len(take)] = 1
        out = model.decode_prompts(sam_embedding, points=torch.from_numpy(pts).to(dev),
                                   labels=torch.from_numpy(labs).to(dev),
                                   return_upscaled=False)
    pred = _bicubic(out["masks"][:, mask_index], gh, gw) > 0
    return mask_iou(pred, gt), pred


def run_interactive_eval(model, sam_embedding, gt_masks, first_clicks, generator=None,
                         evaluator=None, max_clicks: int = MAX_CLICKS, mask_features=None,
                         multi_scale=None, unified: bool = True,
                         sample_fn=sample_fn_click) -> dict[str, Any]:
    """Run the loop and feed each target's IoU trajectory to ``evaluator``
    (an ``InteractiveEvaluator``). Returns {"ious": (rounds, N),
    "final_masks": (N, H, W)} as numpy arrays."""
    unified = unified and mask_features is not None
    loop = make_interactive_loop(model, max_clicks=max_clicks, unified=unified,
                                 sample_fn=sample_fn)
    ious, final = loop(sam_embedding, mask_features, multi_scale, gt_masks, first_clicks,
                       generator)
    ious = ious.cpu().numpy()
    if evaluator is not None:
        for i in range(ious.shape[1]):
            evaluator.process(ious[:, i])
    return {"ious": ious, "final_masks": final.cpu().numpy()}
