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


def softmax_cross_entropy(logits, labels, num_classes, class_weight=None):
    """-log softmax at the label, times its class weight; a label outside
    [0, num_classes) has no hot entry (a zero loss), as
    ``jax.nn.one_hot``."""
    logp = F.log_softmax(logits, dim=-1)
    onehot = (labels.long()[..., None] == torch.arange(
        num_classes, device=logits.device)).to(logits.dtype)
    ce = -(onehot * logp).sum(-1)
    if class_weight is not None:
        cw = torch.as_tensor(class_weight, dtype=logits.dtype,
                             device=logits.device)
        ce = ce * cw[labels.long()]
    return ce


@LOSSES.register_module()
class CrossEntropyLoss:
    def __init__(self, use_sigmoid: bool = False, use_mask: bool = False,
                 reduction: str = 'mean', class_weight=None,
                 loss_weight: float = 1.0):
        self.use_sigmoid = use_sigmoid
        self.class_weight = class_weight
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        """The sum of the per-sample losses (times ``weight``) over
        ``avg_factor``, or their mean without a weight."""
        if self.use_sigmoid:
            loss = binary_cross_entropy_with_logits(pred,
                                                    target.to(pred.dtype))
            if loss.dim() > target.dim():
                loss = loss.sum(-1)
        else:
            loss = softmax_cross_entropy(pred, target, pred.shape[-1],
                                         self.class_weight)
        if weight is not None:
            loss = loss * weight
        total = loss.sum()
        if avg_factor is not None:
            total = total / torch.clamp(torch.as_tensor(avg_factor),
                                        min=1e-12)
        elif weight is None:
            total = total / max(loss.numel(), 1)
        return self.loss_weight * total
