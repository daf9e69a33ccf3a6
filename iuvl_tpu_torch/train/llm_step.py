"""The stage-2 (instruction-tuning) train step, PyTorch port of
``iuvl_tpu/train/llm_step.py``.

The unified decoder's ``'llm'`` task gives the object queries' features,
cut from the gradient; ``img_to_lang`` projects them; they are placed at
each row's image slots in the conversation's embeddings; the frozen LLM's
full-sequence forward over the padded length gives the logits, and the
loss is ``llm_weight`` times :func:`causal_lm_loss`. The encode and the
decoder run under ``torch.no_grad()``: nothing of them reaches the loss's
gradient, so autograd records the projector and the LLM only. The LLM's
parameters do not require a gradient (JAX differentiates the SysLearner's
parameters alone), so the backward computes activation gradients through
every LLM layer down to the spliced embeddings and no weight gradient of
the LLM.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.llm.multimodal import IGNORE_INDEX, IMAGE_TOKEN_INDEX, causal_lm_loss
from .optimizer import Optimizer
from .train_step import TrainState, _update


def place_features(base_embeds: torch.Tensor, feats: torch.Tensor,
                   img_start: torch.Tensor) -> torch.Tensor:
    """(B, L, D) embeddings with each row's (N, D) features placed at its
    start, as ``dynamic_update_slice`` places them (a start that would run
    past the row moves back so that they fit), on a new tensor through
    which the features' gradient flows. Features longer than the row
    raise, as ``dynamic_update_slice`` refuses them."""
    length, n = base_embeds.shape[1], feats.shape[1]
    if n > length:
        raise ValueError(f"place_features: {n} image features do not fit in a row of {length}")
    rows = []
    for i, start in enumerate(img_start.tolist()):
        s = min(max(int(start), 0), length - n)
        rows.append(torch.cat([base_embeds[i, :s], feats[i].to(base_embeds.dtype),
                               base_embeds[i, s + n:]]))
    return torch.stack(rows)


def make_llm_train_step(syslearner, llm, optimizer: Optimizer,
                        llm_weight: float = 1.0) -> Callable:
    """Returns ``step(images, ctx_tokens, base_embeds, img_start,
    attention_mask, labels) -> metrics``: raw RGB (B, H, W, 3), the
    question's (B, contxt_len, dim) token embeddings for the ``'llm'``
    task, and :func:`prepare_llm_batch`'s four tensors. One backward and
    one update of ``optimizer`` (an :class:`Optimizer` over ``syslearner``'s
    parameters; its ``count`` is the step), over every SysLearner parameter:
    one the loss does not reach gets a zero gradient, so weight decay still
    reaches it unless the optimizer freezes it. ``metrics``: ``loss_total``
    and ``loss_llm``, detached scalars (JAX's). The LLM's parameters are set
    not to require a gradient."""
    state = TrainState(optimizer)
    for p in llm.parameters():
        p.requires_grad_(False)

    def step(images, ctx_tokens, base_embeds, img_start, attention_mask, labels):
        for p in syslearner.parameters():
            p.grad = None
        with torch.no_grad():
            image_feature = syslearner.llm_image_features(images, ctx_tokens)
        feats = syslearner.project_image_features(image_feature)
        logits = llm(place_features(base_embeds, feats, img_start), attention_mask)
        loss = llm_weight * causal_lm_loss(logits, labels)
        del logits
        _update(syslearner, state, loss)
        loss = loss.detach()
        return {"loss_total": loss, "loss_llm": loss}

    return step


def prepare_llm_batch(llm, questions_ids, labels, num_image_tokens: int = 100,
                      max_len: int = 1024):
    """Conversation ids (each row with one IMAGE_TOKEN_INDEX) and their
    labels -> (base_embeds (B, max_len, dim) in the LLM's dtype, img_start
    (B,), attention_mask (B, max_len) int32, labels (B, max_len) int64) on
    the LLM's device: each row's ids before the image token, then
    ``num_image_tokens`` slots (id 0, overwritten by the step), then the
    rest, cut at ``max_len`` and right-padded with id 0; labels aligned the
    same way, IGNORE_INDEX in the slots and the padding."""
    b = len(questions_ids)
    out_ids = np.zeros((b, max_len), np.int32)
    img_start = np.zeros(b, np.int64)
    attn = np.zeros((b, max_len), np.int32)
    out_labels = np.full((b, max_len), IGNORE_INDEX, np.int64)
    for i, row in enumerate(questions_ids):
        row = np.asarray(row)
        p = int(np.where(row == IMAGE_TOKEN_INDEX)[0][0])
        pre, post = row[:p], row[p + 1:]
        total = min(len(pre) + num_image_tokens + len(post), max_len)
        post_len = max(total - len(pre) - num_image_tokens, 0)
        out_ids[i, : len(pre)] = pre
        img_start[i] = len(pre)
        out_ids[i, len(pre) + num_image_tokens: total] = post[:post_len]
        attn[i, :total] = 1
        lab = np.asarray(labels[i])
        out_labels[i, : len(pre)] = lab[:p]
        out_labels[i, len(pre) + num_image_tokens: total] = lab[p + 1:][:post_len]
    dev = llm.lm_head.weight.device
    with torch.no_grad():
        base_embeds = llm.embed(torch.from_numpy(out_ids).to(dev))
    return (base_embeds, torch.from_numpy(img_start).to(dev), torch.from_numpy(attn).to(dev),
            torch.from_numpy(out_labels).to(dev))
