"""IoU-family box losses (reference: mmdet/models/losses/iou_loss.py),
counterpart of ``boxinstseg_tpu/models/losses/iou_loss.py``."""
from __future__ import annotations

import math

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
class IoULoss:
    def __init__(self, linear: bool = False, eps: float = 1e-6,
                 reduction: str = 'mean', loss_weight: float = 1.0,
                 mode: str = 'log'):
        self.eps = eps
        self.loss_weight = loss_weight
        self.mode = 'linear' if linear else mode

    def __call__(self, pred, target, weight=None, avg_factor=None):
        iou = aligned_iou(pred, target, mode='iou', eps=self.eps)
        if self.mode == 'linear':
            loss = 1.0 - iou
        elif self.mode == 'square':
            loss = 1.0 - iou ** 2
        else:
            loss = -torch.log(iou.clamp(min=self.eps))
        return self.loss_weight * _reduce(loss, weight, avg_factor)


@LOSSES.register_module()
class GIoULoss:
    def __init__(self, eps: float = 1e-7, reduction: str = 'mean',
                 loss_weight: float = 1.0):
        self.eps = eps
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        giou = aligned_iou(pred, target, mode='giou', eps=self.eps)
        return self.loss_weight * _reduce(1.0 - giou, weight, avg_factor)


def _center_dist_terms(pred, target, eps):
    """DIoU's and CIoU's pieces: the IoU, the squared centre distance rho2
    and the squared diagonal c2 of the enclosing box (reference
    iou_loss.py diou_loss / ciou_loss)."""
    iou = aligned_iou(pred, target, mode='iou', eps=eps)
    lt_e = torch.minimum(pred[..., :2], target[..., :2])
    rb_e = torch.maximum(pred[..., 2:], target[..., 2:])
    wh_e = (rb_e - lt_e).clamp(min=0)
    c2 = wh_e[..., 0] ** 2 + wh_e[..., 1] ** 2 + eps
    rho2 = ((target[..., 0] + target[..., 2]
             - pred[..., 0] - pred[..., 2]) ** 2
            + (target[..., 1] + target[..., 3]
               - pred[..., 1] - pred[..., 3]) ** 2) / 4.0
    return iou, rho2, c2


def _box_weight(weight):
    """A per-coordinate (..., 4) weight becomes a per-box one."""
    if weight is not None and weight.dim() > 1:
        return weight.mean(dim=-1)
    return weight


@LOSSES.register_module()
class DIoULoss:
    """Distance-IoU loss (reference iou_loss.py:102-148 diou_loss)."""

    def __init__(self, eps: float = 1e-6, reduction: str = 'mean',
                 loss_weight: float = 1.0):
        self.eps = eps
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        iou, rho2, c2 = _center_dist_terms(pred, target, self.eps)
        loss = 1.0 - (iou - rho2 / c2)
        return self.loss_weight * _reduce(loss, _box_weight(weight),
                                          avg_factor)


@LOSSES.register_module()
class CIoULoss:
    """Complete-IoU loss (reference iou_loss.py:151-213 ciou_loss): DIoU
    and the aspect-ratio term, whose trade-off alpha is detached and
    gated on IoU > 0.5."""

    def __init__(self, eps: float = 1e-6, reduction: str = 'mean',
                 loss_weight: float = 1.0):
        self.eps = eps
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        eps = self.eps
        iou, rho2, c2 = _center_dist_terms(pred, target, eps)
        w1 = pred[..., 2] - pred[..., 0]
        h1 = pred[..., 3] - pred[..., 1] + eps
        w2 = target[..., 2] - target[..., 0]
        h2 = target[..., 3] - target[..., 1] + eps
        v = (4.0 / math.pi ** 2) * \
            (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        alpha = ((iou > 0.5).to(v.dtype) * v / (1.0 - iou + v)).detach()
        cious = iou - (rho2 / c2 + alpha * v)
        loss = 1.0 - cious.clamp(-1.0, 1.0)
        return self.loss_weight * _reduce(loss, _box_weight(weight),
                                          avg_factor)


@LOSSES.register_module()
class BoundedIoULoss:
    """Fitness-NMS bounded IoU loss (reference iou_loss.py:55-100
    bounded_iou_loss): bounded IoU proxies a coordinate through a smooth
    L1 with beta; the target's centre and size are constants."""

    def __init__(self, beta: float = 0.2, eps: float = 1e-3,
                 reduction: str = 'mean', loss_weight: float = 1.0):
        self.beta = beta
        self.eps = eps
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        eps = self.eps
        pred_ctrx = (pred[..., 0] + pred[..., 2]) * 0.5
        pred_ctry = (pred[..., 1] + pred[..., 3]) * 0.5
        pred_w = pred[..., 2] - pred[..., 0]
        pred_h = pred[..., 3] - pred[..., 1]
        target = target.detach()
        target_ctrx = (target[..., 0] + target[..., 2]) * 0.5
        target_ctry = (target[..., 1] + target[..., 3]) * 0.5
        target_w = target[..., 2] - target[..., 0]
        target_h = target[..., 3] - target[..., 1]
        dx = torch.abs(target_ctrx - pred_ctrx)
        dy = torch.abs(target_ctry - pred_ctry)
        loss_dx = 1 - ((target_w - 2 * dx)
                       / (target_w + 2 * dx + eps)).clamp(min=0.0)
        loss_dy = 1 - ((target_h - 2 * dy)
                       / (target_h + 2 * dy + eps)).clamp(min=0.0)
        loss_dw = 1 - torch.minimum(target_w / (pred_w + eps),
                                    pred_w / (target_w + eps))
        loss_dh = 1 - torch.minimum(target_h / (pred_h + eps),
                                    pred_h / (target_h + eps))
        comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
        loss = torch.where(comb < self.beta, 0.5 * comb * comb / self.beta,
                           comb - 0.5 * self.beta)
        return self.loss_weight * _reduce(loss, weight, avg_factor)
