"""Dice loss (reference: mmdet/models/losses/dice_loss.py and the inline
dice_coefficient in condinst_head.py:117-132), counterpart of
``boxinstseg_tpu/models/losses/dice_loss.py``."""
from __future__ import annotations

import torch

from ...registry import LOSSES


def dice_coefficient(x: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Per-instance dice loss 1 - 2*I/(|x|^2+|t|^2); x, target: (N, ...)."""
    n = x.shape[0]
    x = x.reshape(n, -1)
    target = target.reshape(n, -1)
    inter = (x * target).sum(dim=1)
    union = (x ** 2).sum(dim=1) + (target ** 2).sum(dim=1) + eps
    return 1.0 - 2.0 * inter / union


@LOSSES.register_module()
class DiceLoss:
    def __init__(self, use_sigmoid: bool = True, activate: bool = True,
                 reduction: str = 'mean', naive_dice: bool = False,
                 loss_weight: float = 1.0, eps: float = 1e-3):
        self.activate = activate and use_sigmoid
        self.loss_weight = loss_weight
        self.eps = eps

    def __call__(self, pred, target, weight=None, avg_factor=None):
        """The sum of the per-instance losses (times ``weight``) over
        ``avg_factor``, or over the instance count without it."""
        if self.activate:
            pred = torch.sigmoid(pred)
        loss = dice_coefficient(pred, target, eps=self.eps)
        if weight is not None:
            loss = loss * weight
        total = loss.sum()
        if avg_factor is not None:
            total = total / torch.clamp(torch.as_tensor(avg_factor),
                                        min=1e-12)
        else:
            total = total / max(loss.shape[0], 1)
        return self.loss_weight * total
