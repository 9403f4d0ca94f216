"""Positive and negative samplers with fixed budgets, as random-priority
top-k masks (static shapes), batched over images.

Counterpart of pointtinybenchmark_tpu/core/samplers.py (`topk_mask`,
`random_topk_mask`, `RandomSampler`). Every candidate draws a uniform
priority from a `torch.Generator` on the tensors' device, and the budget's
highest priorities are taken: uniform sampling without replacement. The
draws are not the JAX package's (the generators differ), but the budgets
are its: RandomSampler's negative budget is the static `num - int(num *
pos_fraction)` (samplers.py:92), not mmdet's `num - num_pos`.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

__all__ = ["SamplingResult", "RandomSampler", "random_topk_mask",
           "topk_mask"]


def topk_mask(priority: torch.Tensor,
              k: Union[int, torch.Tensor]) -> torch.Tensor:
    """Mask of the `k` largest entries along the last axis of `priority`
    (k an int, or a tensor of one k per row of the leading axes). Ties go
    to the lower index, as a stable descending sort orders them; NaN counts
    as -inf, so it is taken only after every finite entry."""
    n = priority.shape[-1]
    inf = float("inf")
    key = torch.nan_to_num(priority.float(), nan=-inf, posinf=inf,
                           neginf=-inf)
    order = torch.sort(key, dim=-1, descending=True, stable=True)[1]
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(n, device=order.device).expand_as(
        order))
    k = torch.as_tensor(k, device=priority.device).clamp(0, n)
    if k.dim():
        k = k[..., None]
    return rank < k


def random_topk_mask(generator: torch.Generator, candidate_mask: torch.Tensor,
                     budget: int) -> torch.Tensor:
    """Up to `budget` of the True entries along the last axis, drawn
    uniformly (fewer when there are fewer candidates)."""
    priority = torch.rand(candidate_mask.shape, generator=generator,
                          device=candidate_mask.device)
    priority = torch.where(candidate_mask, priority, -1.0)
    return candidate_mask & topk_mask(priority,
                                      min(budget, candidate_mask.shape[-1]))


class SamplingResult(NamedTuple):
    pos_mask: torch.Tensor         # chosen positives
    neg_mask: torch.Tensor         # chosen negatives
    assigned_gt_inds: torch.Tensor  # 0 background, j + 1 gt j, -1 ignore
    labels: torch.Tensor


class RandomSampler:

    def __init__(self, num: int, pos_fraction: float, neg_pos_ub: int = -1):
        if neg_pos_ub >= 0:
            raise NotImplementedError("neg_pos_ub >= 0 is not ported")
        self.num = num
        self.pos_fraction = pos_fraction

    def sample(self, generator: torch.Generator,
               assigned_gt_inds: torch.Tensor,
               labels: torch.Tensor) -> SamplingResult:
        """Sample from (..., N) assignments (gt-as-proposal rows already
        included by the caller): up to int(num * pos_fraction) positives,
        then negatives up to the static rest of `num`."""
        pos_budget = int(self.num * self.pos_fraction)
        pos_mask = random_topk_mask(generator, assigned_gt_inds > 0,
                                    pos_budget)
        neg_mask = random_topk_mask(generator, assigned_gt_inds == 0,
                                    self.num - pos_budget)
        return SamplingResult(pos_mask, neg_mask, assigned_gt_inds, labels)
