"""Seesaw loss for long-tailed classification, counterpart of
``boxinstseg_tpu/models/losses/seesaw_loss.py`` (reference:
mmdet/models/losses/seesaw_loss.py — seesaw_ce_loss :12-78, SeesawLoss
:81-262).

As in the JAX package, the reference's ``cum_samples`` buffer is explicit
state: ``init_cum_samples`` makes it and ``update_cum_samples`` returns it
updated; the caller carries it between steps. The positive rows are a mask,
not an index.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...registry import LOSSES
from .misc_losses import weight_reduce


def seesaw_ce_loss(cls_score: torch.Tensor,
                   labels: torch.Tensor,
                   label_weights: Optional[torch.Tensor],
                   cum_samples: torch.Tensor,
                   num_classes: int,
                   p: float,
                   q: float,
                   eps: float,
                   reduction: str = 'mean',
                   avg_factor=None,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The seesaw cross-entropy over the rows flagged by ``valid`` (all
    rows without it); ``reduction='mean'`` averages over the valid rows,
    as the reference's boolean-indexed subset does."""
    lab = labels.long().clamp(0, num_classes - 1)
    # jax.nn.one_hot: a label out of range has no hot entry
    onehot = (labels.long()[:, None] == torch.arange(
        num_classes, device=labels.device)).to(cls_score.dtype)
    seesaw = torch.ones_like(cls_score)
    if p > 0:
        cs = cum_samples.clamp(min=1.0)
        ratio = cs[None, :] / cs[:, None]                  # (C, C)
        sample_w = torch.where(ratio < 1.0, ratio ** p,
                               torch.ones_like(ratio))
        seesaw = seesaw * sample_w[lab]
    if q > 0:
        scores = torch.softmax(cls_score.detach(), dim=1)
        self_scores = torch.gather(scores, 1, lab[:, None])[:, 0]
        score_mat = scores / self_scores.clamp(min=eps)[:, None]
        seesaw = seesaw * torch.where(score_mat > 1.0, score_mat ** q,
                                      torch.ones_like(score_mat))
    logits = cls_score + torch.log(seesaw) * (1.0 - onehot)
    loss = -torch.gather(F.log_softmax(logits, dim=1), 1,
                         lab[:, None])[:, 0]
    if label_weights is not None:
        loss = loss * label_weights.to(loss.dtype)
    if valid is not None:
        loss = torch.where(valid, loss, torch.zeros_like(loss))
        if reduction == 'mean' and avg_factor is None:
            return loss.sum() / valid.sum().to(loss.dtype).clamp(min=1.0)
    return weight_reduce(loss, None, reduction, avg_factor)


@LOSSES.register_module()
class SeesawLoss:
    """Softmax seesaw loss in the reference's (C+2)-channel layout: C class
    logits and 2 objectness logits (reference seesaw_loss.py
    ``_split_cls_score`` :141-146, forward :201-262).

    ``init_cum_samples()`` makes the (C+1,) counter;
    ``update_cum_samples(cum, labels)`` is the accumulation the reference
    does in place (forward :230-233)."""

    def __init__(self, use_sigmoid: bool = False, p: float = 0.8,
                 q: float = 2.0, num_classes: int = 1203, eps: float = 1e-2,
                 reduction: str = 'mean', loss_weight: float = 1.0,
                 return_dict: bool = True):
        assert not use_sigmoid, 'SeesawLoss is softmax-only (reference)'
        self.p = p
        self.q = q
        self.num_classes = num_classes
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.return_dict = return_dict

    def init_cum_samples(self, device='cuda') -> torch.Tensor:
        return torch.zeros((self.num_classes + 1,), dtype=torch.float32,
                           device=device)

    def update_cum_samples(self, cum_samples: torch.Tensor,
                           labels: torch.Tensor,
                           valid: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        add = torch.ones(labels.shape, dtype=torch.float32,
                         device=labels.device) if valid is None \
            else valid.to(torch.float32)
        return cum_samples.index_add(
            0, labels.long().clamp(0, self.num_classes), add)

    # custom-classifier hooks (reference :148-198)
    def get_cls_channels(self, num_classes: int) -> int:
        assert num_classes == self.num_classes
        return num_classes + 2

    def get_activation(self, cls_score: torch.Tensor) -> torch.Tensor:
        score_c = torch.softmax(cls_score[..., :-2], dim=-1)
        score_o = torch.softmax(cls_score[..., -2:], dim=-1)
        return torch.cat([score_c * score_o[..., :1], score_o[..., 1:]],
                         dim=-1)

    def __call__(self, cls_score, labels, cum_samples, label_weights=None,
                 avg_factor=None, reduction_override=None):
        reduction = reduction_override or self.reduction
        num_classes = self.num_classes
        assert cls_score.shape[-1] == num_classes + 2
        pos = labels < num_classes
        obj_labels = (labels == num_classes).long()
        if label_weights is None:
            label_weights = torch.ones(labels.shape, dtype=cls_score.dtype,
                                       device=cls_score.device)
        label_weights = label_weights.to(cls_score.dtype)
        loss_classes = self.loss_weight * seesaw_ce_loss(
            cls_score[..., :-2], labels, label_weights,
            cum_samples[:num_classes], num_classes, self.p, self.q,
            self.eps, reduction, avg_factor, valid=pos)
        # objectness: a plain softmax CE over every sample
        ce_o = -torch.gather(F.log_softmax(cls_score[..., -2:], dim=1), 1,
                             obj_labels[:, None])[:, 0]
        loss_objectness = self.loss_weight * weight_reduce(
            ce_o, label_weights, reduction, avg_factor)
        if self.return_dict:
            return dict(loss_cls_objectness=loss_objectness,
                        loss_cls_classes=loss_classes)
        return loss_classes + loss_objectness
