"""Box projection losses, counterpart of
``boxinstseg_tpu/models/losses/projection.py``: dice between the x/y max
projections of the mask scores and of the GT box bitmask. BoxInst's term
(reference: condinst_head.py:134-143) and ``BoxProjectionLoss``, the
module form of BoxLevelset (reference:
mmdet/models/losses/box_projection_loss.py:6-43)."""
from __future__ import annotations

import torch

from ...parallel import dist as pdist
from ...registry import LOSSES


def dice_coefficient(x, target, eps: float = 1e-5):
    """1 - 2|x.t| / (|x|^2 + |t|^2 + eps) over the last axis."""
    inter = (x * target).sum(dim=1)
    union = (x ** 2).sum(dim=1) + (target ** 2).sum(dim=1) + eps
    return 1.0 - 2.0 * inter / union


def _project_dice(scores, boxes, valid, eps: float = 1e-5):
    """Per-instance projection dice over (N, H, W): the dice of the x and
    of the y max projections, summed; invalid rows give 0. ``amax`` splits
    the gradient evenly between tied maxima, as JAX's ``max`` does."""
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    return torch.where(
        valid, dice_coefficient(scores.amax(dim=1), boxes.amax(dim=1), eps)
        + dice_coefficient(scores.amax(dim=2), boxes.amax(dim=2), eps), zero)


def compute_project_term(mask_scores: torch.Tensor,
                         gt_bitmasks: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """BoxInst's projection term: ``_project_dice`` of (N, H, W) mask
    scores and box bitmasks summed over the valid instances ((N,) bool)
    and divided by their count (over the global batch under a process
    group: ``parallel.dist.reduce_mean_denominator``)."""
    return _project_dice(mask_scores, gt_bitmasks, valid).sum() \
        / pdist.reduce_mean_denominator(valid.to(mask_scores.dtype).sum(),
                                        1.0)


@LOSSES.register_module()
class BoxProjectionLoss:
    """``_project_dice`` of mask scores and box masks, (N, H, W) each, at
    ``eps``: the per-instance (N,) vector times ``loss_weight``, as the
    reference module; the SOLO-style heads reduce it themselves
    (box_projection_loss.py:14-20)."""

    def __init__(self, loss_weight: float = 1.0, eps: float = 1e-5):
        self.loss_weight = loss_weight
        self.eps = eps

    def __call__(self, mask_scores, box_bitmasks, valid):
        return self.loss_weight * _project_dice(mask_scores, box_bitmasks,
                                                valid, self.eps)
