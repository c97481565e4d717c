"""BoxInst projection loss (reference: condinst_head.py:134-143),
counterpart of ``boxinstseg_tpu/models/losses/projection.py``: dice
between the x/y max projections of the mask scores and of the GT box
bitmask."""
from __future__ import annotations

import torch


def dice_coefficient(x, target, eps: float = 1e-5):
    """1 - 2|x.t| / (|x|^2 + |t|^2 + eps) over the last axis."""
    inter = (x * target).sum(dim=1)
    union = (x ** 2).sum(dim=1) + (target ** 2).sum(dim=1) + eps
    return 1.0 - 2.0 * inter / union


def _masked_dice(x, t, valid, eps=1e-5):
    """Dice over (N, L) with per-instance validity; invalid rows give 0."""
    loss = dice_coefficient(x, t, eps)
    return torch.where(valid, loss, torch.zeros_like(loss))


def compute_project_term(mask_scores: torch.Tensor,
                         gt_bitmasks: torch.Tensor,
                         valid=None) -> torch.Tensor:
    """Projection dice term.

    Args:
      mask_scores: (N, H, W) sigmoid mask scores.
      gt_bitmasks: (N, H, W) box bitmasks.
      valid: optional (N,) bool; padded instances contribute 0 and the
        mean divides by the valid count.

    ``amax`` splits the gradient evenly between tied maxima, as JAX's
    ``max`` does."""
    px = mask_scores.amax(dim=1)   # (N, W) projection along y
    tx = gt_bitmasks.amax(dim=1)
    py = mask_scores.amax(dim=2)   # (N, H) projection along x
    ty = gt_bitmasks.amax(dim=2)
    if valid is None:
        return (dice_coefficient(px, tx) + dice_coefficient(py, ty)).mean()
    v = valid.to(mask_scores.dtype)
    lx = _masked_dice(px, tx, valid)
    ly = _masked_dice(py, ty, valid)
    return (lx + ly).sum() / v.sum().clamp(min=1.0)
