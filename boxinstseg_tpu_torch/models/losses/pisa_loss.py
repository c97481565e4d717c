"""PISA: importance-based sample reweighting and the classification-aware
regression loss, counterpart of ``boxinstseg_tpu/models/losses/
pisa_loss.py`` (reference: mmdet/models/losses/pisa_loss.py — isr_p
:9-122, carl_loss :125-210).

As in the JAX package, the IoU-HLR double ranking is one grouped rank (a
lexicographic sort and segment offsets) over fixed-size tensors with
masks, not loops over the unique labels and GTs.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ...ops.boxes import aligned_iou


def _rank_desc_in_group(values: torch.Tensor, group: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """The 0-based descending rank of each value within its group (the
    reference's double argsort, pisa_loss.py:93-101); the invalid rows
    get ranks the caller masks."""
    n = values.shape[0]
    g = torch.where(valid, group.long(), torch.full_like(group.long(),
                                                         n + 1))
    # jnp.lexsort((-values, g)): by group, then by value descending
    by_value = torch.argsort(-values, stable=True)
    order = by_value[torch.argsort(g[by_value], stable=True)]
    sg = g[order]
    pos = torch.arange(n, device=values.device)
    start = torch.ones(n, dtype=torch.bool, device=values.device)
    start[1:] = sg[1:] != sg[:-1]
    seg_start = torch.cummax(torch.where(start, pos, torch.full_like(pos, -1)),
                             dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - seg_start
    return rank


def _pick_class_deltas(bbox_pred, labels_c):
    if bbox_pred.shape[-1] > 4:
        bp = bbox_pred.reshape(bbox_pred.shape[0], -1, 4)
        return torch.gather(bp, 1, labels_c[:, None, None].expand(
            -1, 1, 4))[:, 0]
    return bbox_pred


def isr_p(cls_score: torch.Tensor,
          bbox_pred: torch.Tensor,
          bbox_targets: Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor],
          rois: torch.Tensor,
          gts: torch.Tensor,
          loss_cls: Callable,
          bbox_decode: Callable,
          k: float = 2.0,
          bias: float = 0.0,
          num_class: int = 80):
    """Importance-based Sample Reweighting, positive part. As the JAX
    function: ``gts`` is a flat (N,) global GT index a sample,
    ``bbox_decode(rois, deltas) -> boxes`` stands for the box coder.
    Returns the updated (labels, label_weights, bbox_targets,
    bbox_weights)."""
    labels, label_weights, bbox_t, bbox_w = bbox_targets
    pos = (labels >= 0) & (labels < num_class)
    labels_c = labels.long().clamp(0, num_class - 1)
    cls_score = cls_score.detach()
    bbox_pred = bbox_pred.detach()
    if rois.shape[-1] == 5:
        rois = rois[:, 1:]
    boxes_pred = bbox_decode(rois, _pick_class_deltas(bbox_pred, labels_c))
    boxes_target = bbox_decode(rois, bbox_t)
    zero = torch.zeros((), dtype=boxes_pred.dtype, device=boxes_pred.device)
    ious = torch.where(pos, aligned_iou(boxes_pred, boxes_target), zero)
    # the most positives sharing one label
    max_l_num = torch.zeros((num_class,), dtype=torch.float32,
                            device=labels.device).index_add_(
        0, labels_c, pos.to(torch.float32)).max()
    # IoU-HLR: the rank in each (label, GT) group, then in each label
    n_gt = gts.max() + 1 if gts.numel() else 1
    fine_group = labels_c * (n_gt + 1) + gts.long().clamp(min=0)
    t_rank = _rank_desc_in_group(ious, fine_group, pos)
    ious2 = ious + torch.where(pos, max_l_num - t_rank.to(ious.dtype), zero)
    l_rank = _rank_desc_in_group(ious2, labels_c, pos)
    hlr_w = (max_l_num - l_rank.to(ious.dtype)) / max_l_num.clamp(min=1.0)
    pos_imp = (bias + label_weights * hlr_w * (1.0 - bias)) ** k
    # renormalised so that the weighted classification loss keeps its value
    pos_loss_cls = loss_cls(cls_score, labels_c, reduction_override='none')
    if pos_loss_cls.dim() > 1:
        pos_loss_cls = pos_loss_cls.sum(dim=-1)
    pm = pos.to(pos_loss_cls.dtype)
    ori = (pos_loss_cls * label_weights * pm).sum()
    new = (pos_loss_cls * pos_imp * pm).sum()
    new_w = torch.where(pos, pos_imp * (ori / new.clamp(min=1e-12)),
                        label_weights)
    return labels, new_w, bbox_t, bbox_w


def carl_loss(cls_score: torch.Tensor,
              labels: torch.Tensor,
              bbox_pred: torch.Tensor,
              bbox_targets: torch.Tensor,
              loss_bbox: Callable,
              k: float = 1.0,
              bias: float = 0.2,
              avg_factor: Optional[float] = None,
              sigmoid: bool = False,
              num_class: int = 80):
    """Classification-Aware Regression Loss (reference carl_loss
    :125-210), masked. ``loss_bbox(pred, target)`` returns the elementwise
    (N, 4) loss."""
    pos = (labels >= 0) & (labels < num_class)
    labels_c = labels.long().clamp(0, num_class - 1)
    scores = torch.sigmoid(cls_score) if sigmoid \
        else torch.softmax(cls_score, dim=-1)
    pos_score = torch.gather(scores, 1, labels_c[:, None])[:, 0]
    w = (bias + (1.0 - bias) * pos_score) ** k
    pm = pos.to(w.dtype)
    w = w * pm.sum() / (w * pm).sum().clamp(min=1e-12)
    if avg_factor is None:
        avg_factor = bbox_targets.shape[0]
    reg = loss_bbox(_pick_class_deltas(bbox_pred, labels_c),
                    bbox_targets) / avg_factor
    return dict(loss_carl=(reg * (w * pm)[:, None]).sum())
