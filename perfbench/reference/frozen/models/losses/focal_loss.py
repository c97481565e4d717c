"""Sigmoid focal loss (reference: mmdet/models/losses/focal_loss.py),
counterpart of ``boxinstseg_tpu/models/losses/focal_loss.py``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...registry import LOSSES


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       num_classes: int, gamma: float = 2.0,
                       alpha: float = 0.25,
                       weight: Optional[torch.Tensor] = None,
                       avg_factor: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Focal loss over integer labels with background = num_classes.

    logits: (..., num_classes); labels: (...,) in [0, num_classes], where
    num_classes means background (no positive channel). Returns the sum,
    divided by ``avg_factor`` when given."""
    classes = torch.arange(num_classes, device=logits.device)
    onehot = (labels[..., None] == classes).to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = -(onehot * F.logsigmoid(logits)
           + (1.0 - onehot) * F.logsigmoid(-logits))
    p_t = p * onehot + (1.0 - p) * (1.0 - onehot)
    alpha_t = alpha * onehot + (1.0 - alpha) * (1.0 - onehot)
    loss = (alpha_t * ((1.0 - p_t) ** gamma) * ce).sum(dim=-1)
    if weight is not None:
        loss = loss * weight
    total = loss.sum()
    if avg_factor is not None:
        total = total / torch.clamp(torch.as_tensor(avg_factor), min=1e-12)
    return total


@LOSSES.register_module()
class FocalLoss:
    def __init__(self, use_sigmoid: bool = True, gamma: float = 2.0,
                 alpha: float = 0.25, reduction: str = 'mean',
                 loss_weight: float = 1.0, activated: bool = False):
        if not use_sigmoid:
            raise ValueError('only the sigmoid focal loss is supported')
        self.gamma = gamma
        self.alpha = alpha
        self.loss_weight = loss_weight

    def __call__(self, logits, labels, weight=None, avg_factor=None):
        return self.loss_weight * sigmoid_focal_loss(
            logits, labels, logits.shape[-1], self.gamma, self.alpha,
            weight=weight, avg_factor=avg_factor)
