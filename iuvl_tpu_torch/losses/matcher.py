"""Hungarian matcher, PyTorch port of ``iuvl_tpu/losses/matcher.py`` (its
``host`` solver).

cost = cost_class * (-prob[target]) + cost_mask * pairwise sigmoid-CE +
cost_dice * pairwise dice, over points shared by every query and target;
invalid target columns get a large constant cost and absorb the leftover
queries. The assignment is scipy's ``linear_sum_assignment`` on the host,
as the JAX package's ``host`` impl runs it (its device solvers, JV and the
auction, give the same assignment and are not ported).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.point_sample import Draw, point_sample_shared

BIG_COST = 1e6


def pairwise_sigmoid_ce(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """inputs (B, Q, P) logits, targets (B, T, P) in {0, 1} -> (B, Q, T)
    mean binary cross-entropy over the points."""
    p = inputs.shape[-1]
    pos = torch.nn.functional.softplus(-inputs)
    neg = torch.nn.functional.softplus(inputs)
    return (torch.einsum("bqp,btp->bqt", pos, targets)
            + torch.einsum("bqp,btp->bqt", neg, 1.0 - targets)) / p


def pairwise_dice(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """inputs (B, Q, P) logits, targets (B, T, P) -> (B, Q, T) dice loss."""
    probs = torch.sigmoid(inputs)
    numerator = 2.0 * torch.einsum("bqp,btp->bqt", probs, targets)
    denominator = probs.sum(-1)[:, :, None] + targets.sum(-1)[:, None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


@torch.no_grad()
def compute_match_cost(draw: Draw, name: str, pred_logits, pred_masks, tgt_labels, tgt_masks,
                       tgt_valid, num_points: int = 12544, cost_class: float = 2.0,
                       cost_mask: float = 5.0, cost_dice: float = 5.0) -> torch.Tensor:
    """(B, Q, T) matching cost; the shared points are ``draw(name,
    (B, num_points, 2))``."""
    b = pred_logits.shape[0]
    prob = torch.softmax(pred_logits.float(), dim=-1)
    c_class = -torch.gather(prob, 2, tgt_labels.long()[:, None, :].expand(-1, prob.shape[1], -1))
    coords = draw(name, (b, num_points, 2))
    pm = point_sample_shared(pred_masks.float(), coords)
    tm = point_sample_shared(tgt_masks.float(), coords, store_dtype=torch.bfloat16)
    cost = (cost_class * c_class + cost_mask * pairwise_sigmoid_ce(pm, tm)
            + cost_dice * pairwise_dice(pm, tm))
    cost = torch.where(torch.isfinite(cost), cost, torch.full_like(cost, BIG_COST))
    return torch.where(tgt_valid[:, None, :], cost, torch.full_like(cost, BIG_COST))


def _lsa_host(cost: np.ndarray) -> np.ndarray:
    """Per-image ``linear_sum_assignment``: (B, Q, T) -> (B, T) query index
    per target column."""
    from scipy.optimize import linear_sum_assignment

    cost = np.nan_to_num(np.asarray(cost, dtype=np.float64), nan=BIG_COST)
    b, _, t = cost.shape
    out = np.zeros((b, t), dtype=np.int64)
    for i in range(b):
        rows, cols = linear_sum_assignment(cost[i])
        out[i, cols] = rows
    return out


def hungarian_match(cost: torch.Tensor) -> torch.Tensor:
    """(B, Q, T) cost -> (B, T) assigned query per target (host solver)."""
    return torch.from_numpy(_lsa_host(cost.detach().float().cpu().numpy())).to(cost.device)


def batched_hungarian(costs: list) -> list:
    """Solve several (B, Q, T_i) problems at once, as the JAX matcher does:
    T padded to a common width with uniform BIG_COST columns, which cannot
    change the valid sub-assignment. Returns the (B, T_i) assignments."""
    if len(costs) == 1:
        return [hungarian_match(costs[0])]
    tmax = max(c.shape[2] for c in costs)
    padded = [torch.nn.functional.pad(c, (0, tmax - c.shape[2]), value=BIG_COST) for c in costs]
    out = hungarian_match(torch.cat(padded, dim=0))
    res, off = [], 0
    for c in costs:
        res.append(out[off:off + c.shape[0], :c.shape[2]])
        off += c.shape[0]
    return res
