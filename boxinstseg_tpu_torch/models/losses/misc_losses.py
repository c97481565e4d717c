"""Auxiliary loss zoo, counterpart of
``boxinstseg_tpu/models/losses/misc_losses.py`` (reference:
mmdet/models/losses/{smooth_l1_loss,mse_loss,gaussian_focal_loss,
varifocal_loss,balanced_l1_loss,gfocal_loss,ghm_loss,kd_loss,
accuracy}.py). None of the four box-supervised methods uses these; they
are registered options with the reference's formulas."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...ops.nms import top_k
from ...registry import LOSSES


def weight_reduce(loss, weight=None, reduction='mean', avg_factor=None):
    """mmcv weight_reduce_loss semantics (losses/utils.py:30-56)."""
    if weight is not None:
        loss = loss * weight
    if reduction == 'none':
        return loss
    if reduction == 'sum':
        return loss.sum()
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / avg_factor


@LOSSES.register_module()
class L1Loss:
    def __init__(self, reduction='mean', loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        loss = torch.abs(pred - target)
        return self.loss_weight * weight_reduce(loss, weight,
                                                self.reduction, avg_factor)


@LOSSES.register_module()
class SmoothL1Loss:
    """Huber loss with beta (reference smooth_l1_loss.py:12-31)."""

    def __init__(self, beta=1.0, reduction='mean', loss_weight=1.0):
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        diff = torch.abs(pred - target)
        loss = torch.where(diff < self.beta,
                           0.5 * diff * diff / self.beta,
                           diff - 0.5 * self.beta)
        return self.loss_weight * weight_reduce(loss, weight,
                                                self.reduction, avg_factor)


@LOSSES.register_module()
class MSELoss:
    def __init__(self, reduction='mean', loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        loss = (pred - target) ** 2
        return self.loss_weight * weight_reduce(loss, weight,
                                                self.reduction, avg_factor)


@LOSSES.register_module()
class GaussianFocalLoss:
    """Focal loss for gaussian heatmaps (reference
    gaussian_focal_loss.py:10-35): positives where target == 1."""

    def __init__(self, alpha=2.0, gamma=4.0, reduction='mean',
                 loss_weight=1.0):
        self.alpha = alpha
        self.gamma = gamma
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        eps = 1e-12
        pos = (target == 1).to(pred.dtype)
        neg = (1 - target) ** self.gamma
        loss = -(torch.log(pred + eps) * (1 - pred) ** self.alpha * pos
                 + torch.log(1 - pred + eps) * pred ** self.alpha * neg
                 * (1 - pos))
        return self.loss_weight * weight_reduce(loss, weight,
                                                self.reduction, avg_factor)


@LOSSES.register_module()
class VarifocalLoss:
    """IoU-aware classification loss (reference varifocal_loss.py:10-53)."""

    def __init__(self, use_sigmoid=True, alpha=0.75, gamma=2.0,
                 iou_weighted=True, reduction='mean', loss_weight=1.0):
        assert use_sigmoid
        self.alpha = alpha
        self.gamma = gamma
        self.iou_weighted = iou_weighted
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        p = torch.sigmoid(pred)
        ce = _bce_with_logits(pred, target)
        pos_mask = (target > 0).to(pred.dtype)
        pos_term = target * pos_mask if self.iou_weighted else pos_mask
        focal = pos_term + self.alpha * torch.abs(p - target) ** \
            self.gamma * (1 - pos_mask)
        return self.loss_weight * weight_reduce(ce * focal, weight,
                                                self.reduction, avg_factor)


def _bce_with_logits(pred, target):
    return pred.clamp(min=0) - pred * target + torch.log1p(
        torch.exp(-torch.abs(pred)))


@LOSSES.register_module()
class BalancedL1Loss:
    """Libra R-CNN balanced L1 (reference balanced_l1_loss.py:13-52)."""

    def __init__(self, alpha=0.5, gamma=1.5, beta=1.0, reduction='mean',
                 loss_weight=1.0):
        self.alpha = alpha
        self.gamma = gamma
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        a, g, beta = self.alpha, self.gamma, self.beta
        diff = torch.abs(pred - target)
        b = math.e ** (g / a) - 1
        loss = torch.where(
            diff < beta,
            a / b * (b * diff + 1) * torch.log(b * diff / beta + 1)
            - a * diff,
            g * diff + g / b - a * beta)
        return self.loss_weight * weight_reduce(loss, weight,
                                                self.reduction, avg_factor)


@LOSSES.register_module()
class QualityFocalLoss:
    """Generalized Focal Loss QFL (reference gfocal_loss.py:12-53): joint
    classification-quality logits supervised by the IoU score at the GT
    class, zero elsewhere."""

    def __init__(self, use_sigmoid=True, beta=2.0, reduction='mean',
                 loss_weight=1.0):
        assert use_sigmoid
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        label, score = target               # (N,), (N,)
        c = pred.shape[1]
        p = torch.sigmoid(pred)
        # negatives: a 0-quality target on every channel
        loss = _bce_with_logits(pred, torch.zeros_like(pred)) * \
            p ** self.beta
        # positives: the quality target on the GT channel
        pos = (label >= 0) & (label < c)
        onehot = torch.arange(c, device=pred.device)[None, :] == \
            torch.where(pos, label, torch.full_like(label, c))[:, None]
        sf = torch.abs(score[:, None] - p) ** self.beta
        pos_loss = _bce_with_logits(pred, score[:, None] *
                                    torch.ones_like(pred)) * sf
        loss = torch.where(onehot, pos_loss, loss).sum(dim=1)
        return self.loss_weight * weight_reduce(loss, weight,
                                                self.reduction, avg_factor)


@LOSSES.register_module()
class DistributionFocalLoss:
    """Generalized Focal Loss DFL (reference gfocal_loss.py:103-125):
    cross-entropy on the two integral bins around the continuous distance
    label, linearly weighted."""

    def __init__(self, reduction='mean', loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, label, weight=None, avg_factor=None):
        left = label.to(torch.int64)
        right = left + 1
        wl = right.to(pred.dtype) - label
        wr = label - left.to(pred.dtype)
        logp = F.log_softmax(pred, dim=-1)
        ce_l = -torch.gather(logp, 1, left[:, None])[:, 0]
        ce_r = -torch.gather(
            logp, 1, right.clamp(0, pred.shape[-1] - 1)[:, None])[:, 0]
        loss = ce_l * wl + ce_r * wr
        return self.loss_weight * weight_reduce(loss, weight,
                                                self.reduction, avg_factor)


@LOSSES.register_module()
class KnowledgeDistillationKLDivLoss:
    """Temperature-scaled KL distillation (reference kd_loss.py:12-37)."""

    def __init__(self, reduction='mean', loss_weight=1.0, T=10):
        self.T = T
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, soft_label, weight=None, avg_factor=None):
        t = torch.softmax(soft_label.detach() / self.T, dim=1)
        logp = F.log_softmax(pred / self.T, dim=1)
        # F.kl_div(logp, t) = t * (log t - logp), 0 * log 0 -> 0
        kl = t * (torch.log(t.clamp(min=1e-30)) - logp)
        loss = kl.mean(dim=1) * (self.T * self.T)
        return self.loss_weight * weight_reduce(loss, weight,
                                                self.reduction, avg_factor)


def _ghm_weights(g, valid, bins, eps=1e-6):
    """Gradient-density weights of GHMC / GHMR (reference ghm_loss.py:
    95-111, 196-210): tot / count(bin), over the number of non-empty bins;
    no host read."""
    idx = (g * bins).to(torch.int64).clamp(0, bins - 1)
    counts = torch.zeros((bins,), dtype=torch.float32,
                         device=g.device).index_add_(
        0, idx.reshape(-1), valid.to(torch.float32).reshape(-1))
    tot = valid.sum().to(torch.float32).clamp(min=1.0)
    n = (counts > 0).sum().to(torch.float32).clamp(min=1.0)
    w = torch.where(counts > 0, tot / counts.clamp(min=eps), 0.0)
    return torch.where(valid.reshape(g.shape), w[idx], 0.0) / n, tot


@LOSSES.register_module()
class GHMC:
    """GHM classification loss (reference ghm_loss.py:23-119), the
    stateless momentum=0 form."""

    def __init__(self, bins=10, momentum=0, use_sigmoid=True,
                 loss_weight=1.0, reduction='mean'):
        assert use_sigmoid and momentum == 0
        self.bins = bins
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, label_weight, avg_factor=None):
        target = target.to(pred.dtype)
        valid = label_weight > 0
        g = torch.abs(torch.sigmoid(pred).detach() - target)
        weights, tot = _ghm_weights(g, valid, self.bins)
        loss = _bce_with_logits(pred, target)
        return self.loss_weight * weight_reduce(loss, weights,
                                                self.reduction, tot)


@LOSSES.register_module()
class GHMR:
    """GHM regression loss on the authentic smooth L1 (reference
    ghm_loss.py:122-232), the stateless momentum=0 form."""

    def __init__(self, mu=0.02, bins=10, momentum=0, loss_weight=1.0,
                 reduction='mean'):
        assert momentum == 0
        self.mu = mu
        self.bins = bins
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, label_weight, avg_factor=None):
        mu = self.mu
        diff = pred - target
        loss = torch.sqrt(diff * diff + mu * mu) - mu
        g = torch.abs(diff / torch.sqrt(mu * mu + diff * diff)).detach()
        weights, tot = _ghm_weights(g, label_weight > 0, self.bins)
        return self.loss_weight * weight_reduce(loss, weights,
                                                self.reduction, tot)


class Accuracy:
    """Module-style wrapper over :func:`accuracy` (reference
    accuracy.py:54-78)."""

    def __init__(self, topk=(1, ), thresh=None):
        self.topk = topk
        self.thresh = thresh

    def __call__(self, pred, target):
        return accuracy(pred, target, self.topk, self.thresh)


def accuracy(pred, target, topk=1, thresh=None):
    """Top-k accuracy in percent (reference accuracy.py:7-51); ties go to
    the lower class, as ``jax.lax.top_k``."""
    ks = (topk,) if isinstance(topk, int) else tuple(topk)
    maxk = max(ks)
    if pred.shape[0] == 0:
        accu = [torch.zeros((), device=pred.device) for _ in ks]
        return accu[0] if isinstance(topk, int) else accu
    pred_val, pred_label = top_k(pred, maxk)                # (N, maxk)
    correct = pred_label == target[:, None]
    if thresh is not None:
        correct = correct & (pred_val > thresh)
    res = [correct[:, :k].sum() * 100.0 / pred.shape[0] for k in ks]
    return res[0] if isinstance(topk, int) else res
