"""IoU-family box losses (reference: mmdet/models/losses/iou_loss.py),
counterpart of ``boxinstseg_tpu/models/losses/iou_loss.py``."""
from __future__ import annotations

import torch

from ...ops.boxes import aligned_iou
from ...registry import LOSSES


def _reduce(loss, weight, avg_factor):
    if weight is not None:
        loss = loss * weight
    total = loss.sum()
    if avg_factor is not None:
        total = total / torch.clamp(torch.as_tensor(avg_factor), min=1e-12)
    return total


@LOSSES.register_module()
class GIoULoss:
    def __init__(self, eps: float = 1e-7, reduction: str = 'mean',
                 loss_weight: float = 1.0):
        self.eps = eps
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        giou = aligned_iou(pred, target, mode='giou', eps=self.eps)
        return self.loss_weight * _reduce(1.0 - giou, weight, avg_factor)
