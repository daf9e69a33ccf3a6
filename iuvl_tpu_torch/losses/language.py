"""Language-side contrastive losses, PyTorch port of
``iuvl_tpu/losses/language.py``: symmetric InfoNCE over a similarity
matrix, and the soft-target variant in which duplicate texts share credit
through a group matrix (static shapes: the reference's hashing of
duplicate texts becomes a precomputed matrix).
"""

from __future__ import annotations

import torch

MAX_LOGIT_SCALE = 100.0


def clamped_scale(logit_scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.exp(logit_scale), max=MAX_LOGIT_SCALE)


def vl_similarity(image_feat, text_feat, logit_scale):
    return clamped_scale(logit_scale) * image_feat @ text_feat.t()


def soft_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(soft_targets * logp).sum(-1).mean()


def contrastive_loss(image_feat, text_feat, logit_scale, valid=None) -> torch.Tensor:
    """Symmetric InfoNCE of (N, D) unit image and text features (row i
    pairs with row i); ``valid`` (N,) masks padded texts as candidates and
    their rows out of the mean."""
    logits = vl_similarity(image_feat, text_feat, logit_scale)
    n = logits.shape[0]
    big_neg = 0.0
    if valid is not None:
        big_neg = torch.where(valid, 0.0, -1e9)[None, :]
        logits = logits + big_neg
    labels = torch.arange(n, device=logits.device)[:, None]
    nll_i = -torch.gather(torch.log_softmax(logits, dim=-1), 1, labels)[:, 0]
    nll_t = -torch.gather(torch.log_softmax(logits.t() + big_neg, dim=-1), 1, labels)[:, 0]
    if valid is not None:
        w = valid.float()
        return 0.5 * ((nll_i * w).sum() + (nll_t * w).sum()) / torch.clamp(w.sum(), min=1.0)
    return 0.5 * (nll_i.mean() + nll_t.mean())


def ql_multi_contrastive_loss(image_feat, text_feat, group_matrix, logit_scale,
                              valid=None) -> torch.Tensor:
    """Soft-target CE of (N, D) query and text features where duplicate
    texts (``group_matrix`` (N, N), 1 iff text i == text j) share credit:
    0.7 of the image-side loss and 0.3 of the text-side one."""
    logits = vl_similarity(image_feat, text_feat, logit_scale)
    if valid is not None:
        logits = logits + torch.where(valid, 0.0, -1e9)[None, :]
        group_matrix = group_matrix * valid[None, :] * valid[:, None]
    gt_img = group_matrix / torch.clamp(group_matrix.sum(-1, keepdim=True), min=1e-7)
    gt_txt = group_matrix / torch.clamp(group_matrix.sum(0, keepdim=True), min=1e-7)
    return (0.7 * soft_cross_entropy(logits, gt_img)
            + 0.3 * soft_cross_entropy(logits.t(), gt_txt.t()))
