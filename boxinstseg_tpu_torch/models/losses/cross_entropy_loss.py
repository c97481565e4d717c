"""Cross-entropy losses (reference:
mmdet/models/losses/cross_entropy_loss.py), counterpart of
``boxinstseg_tpu/models/losses/cross_entropy_loss.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...registry import LOSSES


def binary_cross_entropy_with_logits(logits, targets):
    return -(targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


@LOSSES.register_module()
class CrossEntropyLoss:
    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 reduction: str = 'mean', class_weight=None,
                 loss_weight: float = 1.0):
        if not use_sigmoid:
            raise NotImplementedError('the softmax cross-entropy is not '
                                      'ported yet')
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        loss = binary_cross_entropy_with_logits(pred, target.to(pred.dtype))
        if weight is not None:
            loss = loss * weight
        total = loss.sum()
        if avg_factor is not None:
            total = total / torch.clamp(torch.as_tensor(avg_factor),
                                        min=1e-12)
        elif weight is None:
            total = total / max(loss.numel(), 1)
        return self.loss_weight * total
