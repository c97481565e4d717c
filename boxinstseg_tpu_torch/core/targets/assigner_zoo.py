"""The assigner zoo, counterpart of
``boxinstseg_tpu/core/targets/assigner_zoo.py`` (reference:
mmdet/core/bbox/assigners/{atss,point,grid,uniform,task_aligned,sim_ota,
approx_max_iou,hungarian}_assigner.py and match_cost.py).

Every per-GT loop of the reference is a masked reduction over padded
tensors, as in the JAX package. Conventions (as ``assigners.py``):
``gt_bboxes`` is a padded (K, 4), ``gt_valid`` (K,) masks its real rows;
``assigned`` (N,) int64 holds -1 ignore / 0 negative / g+1 positive.
``hungarian_bbox_assign`` solves through ``ops.lsa.solve_lsa``: the CUDA
kernel on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ...ops.boxes import aligned_iou
from ...ops.lsa import solve_lsa
from .assigners import (assign_wrt_overlaps, bbox_overlaps, labels_of,
                        largest_claim)

INF = 1e8


def _centers(boxes: torch.Tensor):
    return (boxes[:, 0] + boxes[:, 2]) / 2.0, \
        (boxes[:, 1] + boxes[:, 3]) / 2.0


def _rank_smallest(values: torch.Tensor, dim: int) -> torch.Tensor:
    """How many entries along ``dim`` come before each in a stable
    ascending sort (torch.topk(largest=False)'s place for distinct
    values)."""
    return torch.argsort(torch.argsort(values, dim=dim, stable=True),
                         dim=dim, stable=True)


def _inside(px, py, gt_bboxes, margin: float) -> torch.Tensor:
    """(n, k): point n's distance to GT k's nearest side exceeds
    ``margin``."""
    l_ = px[:, None] - gt_bboxes[None, :, 0]
    t_ = py[:, None] - gt_bboxes[None, :, 1]
    r_ = gt_bboxes[None, :, 2] - px[:, None]
    b_ = gt_bboxes[None, :, 3] - py[:, None]
    return torch.minimum(torch.minimum(l_, r_),
                         torch.minimum(t_, b_)) > margin


def _best_iou_of(is_pos, overlaps):
    """Among the GTs that claim a box, the one of highest IoU: (assigned,
    its IoU (0 where none), its index)."""
    ov_inf = torch.where(is_pos, overlaps, torch.full_like(overlaps, -INF))
    max_ov = ov_inf.amax(dim=1)
    arg = ov_inf.argmax(dim=1)
    hit = max_ov > -INF
    assigned = torch.where(hit, arg + 1, torch.zeros_like(arg))
    return assigned, torch.where(hit, max_ov, torch.zeros_like(max_ov)), \
        arg, hit


def atss_assign(bboxes: torch.Tensor,
                num_level_bboxes: Sequence[int],
                gt_bboxes: torch.Tensor,
                gt_valid: torch.Tensor,
                topk: int = 9,
                gt_labels: Optional[torch.Tensor] = None):
    """ATSS (reference atss_assigner.py:60-234): per-level centre-distance
    top-k candidates, a mean + std IoU threshold, centres inside the GT,
    the highest IoU across GTs."""
    overlaps = bbox_overlaps(bboxes[:, :4], gt_bboxes)     # (n, k)
    bx, by = _centers(bboxes[:, :4])
    gx, gy = _centers(gt_bboxes)
    dist = torch.sqrt((bx[:, None] - gx[None, :]) ** 2
                      + (by[:, None] - gy[None, :]) ** 2)
    cand = torch.zeros_like(overlaps, dtype=torch.bool)
    start = 0
    for n_lvl in num_level_bboxes:
        cand[start:start + n_lvl] = _rank_smallest(
            dist[start:start + n_lvl], 0) < min(topk, n_lvl)
        start += n_lvl
    # mean + unbiased std over exactly sum(min(topk, n_lvl)) candidates
    n_cand = sum(min(topk, n_lvl) for n_lvl in num_level_bboxes)
    cf = cand.to(overlaps.dtype)
    mean = (overlaps * cf).sum(dim=0) / n_cand
    var = ((overlaps - mean[None, :]) ** 2 * cf).sum(dim=0) / \
        max(n_cand - 1, 1)
    thr = mean + torch.sqrt(var)
    is_pos = cand & (overlaps >= thr[None, :]) & \
        _inside(bx, by, gt_bboxes, 0.01) & gt_valid[None, :]
    assigned, max_ov, _, _ = _best_iou_of(is_pos, overlaps)
    return assigned, max_ov, labels_of(assigned, gt_labels)


def point_assign(points: torch.Tensor,
                 gt_bboxes: torch.Tensor,
                 gt_valid: torch.Tensor,
                 scale: float = 4.0,
                 pos_num: int = 3,
                 gt_labels: Optional[torch.Tensor] = None):
    """PointAssigner (reference point_assigner.py:30-134): each GT claims
    its ``pos_num`` closest points of its level; a contested point goes to
    the closest GT (the earlier on exact ties)."""
    pts_xy = points[:, :2]
    pts_lvl = torch.log2(points[:, 2]).to(torch.int32)
    gt_xy = (gt_bboxes[:, :2] + gt_bboxes[:, 2:]) / 2.0
    gt_wh = (gt_bboxes[:, 2:] - gt_bboxes[:, :2]).clamp(min=1e-6)
    gt_lvl = ((torch.log2(gt_wh[:, 0] / scale)
               + torch.log2(gt_wh[:, 1] / scale)) / 2.0).to(torch.int32)
    gt_lvl = torch.clamp(gt_lvl, pts_lvl.min(), pts_lvl.max())
    d = torch.linalg.norm(
        (pts_xy[:, None, :] - gt_xy[None, :, :]) / gt_wh[None, :, :],
        dim=-1)                                             # (n, k)
    inf = torch.full_like(d, float('inf'))
    d_m = torch.where((pts_lvl[:, None] == gt_lvl[None, :])
                      & gt_valid[None, :], d, inf)
    cand = (_rank_smallest(d_m, 0) < pos_num) & torch.isfinite(d_m)
    d_c = torch.where(cand, d_m, inf)
    win = torch.argmin(d_c, dim=1)
    has = torch.isfinite(d_c.amin(dim=1))
    assigned = torch.where(has, win + 1, torch.zeros_like(win))
    return assigned, None, labels_of(assigned, gt_labels)


def grid_assign(bboxes: torch.Tensor,
                box_responsible_flags: torch.Tensor,
                gt_bboxes: torch.Tensor,
                gt_valid: torch.Tensor,
                pos_iou_thr: float = 0.5,
                neg_iou_thr=0.3,
                min_pos_iou: float = 0.0,
                gt_max_assign_all: bool = True,
                gt_labels: Optional[torch.Tensor] = None):
    """GridAssigner (reference grid_assigner.py:40-156): MaxIoU limited to
    the cell-responsible boxes; the forced match is the largest eligible
    GT."""
    flags = box_responsible_flags.bool()
    overlaps = bbox_overlaps(gt_bboxes, bboxes)            # (k, n)
    neg1 = torch.full_like(overlaps, -1.0)
    overlaps = torch.where(gt_valid[:, None], overlaps, neg1)
    n = bboxes.shape[0]
    assigned = torch.full((n,), -1, dtype=torch.long, device=bboxes.device)
    max_all = overlaps.amax(dim=0)
    if isinstance(neg_iou_thr, (tuple, list)):
        neg = (max_all > neg_iou_thr[0]) & (max_all <= neg_iou_thr[1])
    else:
        neg = (max_all >= 0) & (max_all <= neg_iou_thr)
    assigned = torch.where(neg, torch.zeros_like(assigned), assigned)
    # responsible-only IoUs from here on (reference :121)
    ov_r = torch.where(flags[None, :], overlaps, neg1)
    max_r, arg_r = ov_r.amax(dim=0), ov_r.argmax(dim=0)
    assigned = torch.where((max_r > pos_iou_thr) & flags, arg_r + 1,
                           assigned)
    gt_max, gt_argmax = ov_r.amax(dim=1), ov_r.argmax(dim=1)
    gt_ok = gt_valid & (gt_max > min_pos_iou)
    if gt_max_assign_all:
        claim = ov_r == gt_max[:, None]
    else:
        claim = torch.zeros_like(ov_r, dtype=torch.bool)
        claim[torch.arange(ov_r.shape[0], device=ov_r.device),
              gt_argmax] = True
    best = largest_claim(claim & flags[None, :] & gt_ok[:, None])
    assigned = torch.where(best > 0, best, assigned)
    return assigned, max_r.clamp(min=0.0), labels_of(assigned, gt_labels)


def _cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    return torch.stack([(boxes[..., 0] + boxes[..., 2]) / 2,
                        (boxes[..., 1] + boxes[..., 3]) / 2,
                        boxes[..., 2] - boxes[..., 0],
                        boxes[..., 3] - boxes[..., 1]], dim=-1)


def uniform_assign(bbox_pred: torch.Tensor,
                   anchor: torch.Tensor,
                   gt_bboxes: torch.Tensor,
                   gt_valid: torch.Tensor,
                   pos_ignore_thr: float = 0.15,
                   neg_ignore_thr: float = 0.7,
                   match_times: int = 4,
                   gt_labels: Optional[torch.Tensor] = None):
    """YOLOF UniformAssigner (reference uniform_assigner.py:30-135): each
    GT's ``match_times`` L1-closest predictions and anchors become
    positives, the anchors' claims written after the predictions' (the
    last write to a prior wins, :84-114); unmatched predictions of high
    IoU are ignored."""
    k = gt_bboxes.shape[0]
    g = _cxcywh(gt_bboxes)
    c_pred = torch.abs(_cxcywh(bbox_pred)[:, None] - g[None]).sum(-1)
    c_anc = torch.abs(_cxcywh(anchor)[:, None] - g[None]).sum(-1)
    zeros = torch.zeros((), device=bbox_pred.device)
    pred_ov = torch.where(gt_valid[None, :],
                          bbox_overlaps(bbox_pred, gt_bboxes), zeros)
    anc_ov = torch.where(gt_valid[None, :],
                         bbox_overlaps(anchor, gt_bboxes), zeros)
    assigned = torch.where(pred_ov.amax(dim=1) > neg_ignore_thr,
                           torch.full((bbox_pred.shape[0],), -1,
                                      device=bbox_pred.device),
                           torch.zeros((bbox_pred.shape[0],),
                                       dtype=torch.long,
                                       device=bbox_pred.device))
    gid = torch.arange(k, device=bbox_pred.device)

    def slot_order(rank, set_id):
        order = rank * (2 * k) + set_id * k + gid[None, :]
        live = (rank < match_times) & gt_valid[None, :]
        return torch.where(live, order, torch.full_like(order, -1))

    order = torch.cat([slot_order(_rank_smallest(c_pred, 0), 0),
                       slot_order(_rank_smallest(c_anc, 0), 1)], dim=1)
    value = torch.where(anc_ov >= pos_ignore_thr, gid[None, :] + 1,
                        torch.full_like(gid, -1)[None, :])
    value = torch.cat([value, value], dim=1)
    picked = torch.gather(value, 1, order.argmax(dim=1, keepdim=True))[:, 0]
    assigned = torch.where(order.amax(dim=1) >= 0, picked, assigned)
    return assigned, anc_ov.amax(dim=0), labels_of(assigned, gt_labels)


def task_aligned_assign(pred_scores: torch.Tensor,
                        decode_bboxes: torch.Tensor,
                        anchors: torch.Tensor,
                        gt_bboxes: torch.Tensor,
                        gt_valid: torch.Tensor,
                        gt_labels: torch.Tensor,
                        topk: int = 13,
                        alpha: float = 1.0,
                        beta: float = 6.0):
    """TOOD TaskAlignedAssigner (reference task_aligned_assigner.py:
    40-151): alignment metric score^alpha * IoU^beta, top-k a GT, centres
    inside the GT, the highest IoU across GTs. Returns (assigned, IoU,
    labels, the assigned alignment metric)."""
    n = anchors.shape[0]
    overlaps = bbox_overlaps(decode_bboxes, gt_bboxes).detach()
    scores = pred_scores[:, gt_labels.clamp(min=0).long()].detach()
    metric = scores ** alpha * overlaps ** beta
    metric = torch.where(gt_valid[None, :], metric,
                         torch.full_like(metric, -float('inf')))
    is_pos = (_rank_smallest(-metric, 0) < min(topk, n)) & (metric > 0)
    ax, ay = _centers(anchors[:, :4])
    is_pos = is_pos & _inside(ax, ay, gt_bboxes, 0.01) & gt_valid[None, :]
    assigned, max_ov, arg, hit = _best_iou_of(is_pos, overlaps)
    metrics = torch.where(hit, torch.gather(metric, 1, arg[:, None])[:, 0],
                          torch.zeros_like(max_ov))
    return assigned, max_ov, labels_of(assigned, gt_labels), metrics


def sim_ota_assign(pred_scores: torch.Tensor,
                   priors: torch.Tensor,
                   decoded_bboxes: torch.Tensor,
                   gt_bboxes: torch.Tensor,
                   gt_valid: torch.Tensor,
                   gt_labels: torch.Tensor,
                   center_radius: float = 2.5,
                   candidate_topk: int = 10,
                   iou_weight: float = 3.0,
                   cls_weight: float = 1.0,
                   eps: float = 1e-7):
    """YOLOX SimOTA (reference sim_ota_assigner.py:95-257): dynamic-k
    matching on a classification + IoU cost, candidates the priors inside
    a GT or its centre region; the other priors cost 2 * INF and never
    match."""
    n = decoded_bboxes.shape[0]
    k = gt_bboxes.shape[0]
    px, py = priors[:, 0], priors[:, 1]
    sx, sy = priors[:, 2], priors[:, 3]
    in_gt = _inside(px, py, gt_bboxes, 0.0) & gt_valid[None, :]
    gx, gy = _centers(gt_bboxes)
    cl = px[:, None] - (gx[None, :] - center_radius * sx[:, None])
    ct = py[:, None] - (gy[None, :] - center_radius * sy[:, None])
    cr = (gx[None, :] + center_radius * sx[:, None]) - px[:, None]
    cb = (gy[None, :] + center_radius * sy[:, None]) - py[:, None]
    in_ct = (torch.minimum(torch.minimum(cl, cr), torch.minimum(ct, cb))
             > 0) & gt_valid[None, :]
    valid = in_gt.any(dim=1) | in_ct.any(dim=1)
    in_both = in_gt & in_ct
    both_valid = gt_valid[None, :] & valid[:, None]
    ious = torch.where(both_valid, bbox_overlaps(decoded_bboxes, gt_bboxes),
                       torch.zeros((), device=priors.device))
    iou_cost = -torch.log(ious + eps)
    onehot = F.one_hot(gt_labels.clamp(min=0).long(),
                       pred_scores.shape[-1]).to(pred_scores.dtype)
    sq = torch.sqrt(pred_scores.clamp(0.0, 1.0))
    # BCE(sqrt(p), onehot) summed over the classes, (n, k)
    bce = -(onehot[None] * torch.log(sq[:, None].clamp(min=eps))
            + (1 - onehot[None])
            * torch.log((1 - sq[:, None]).clamp(min=eps)))
    cost = bce.sum(-1) * cls_weight + iou_cost * iou_weight \
        + (~in_both) * INF
    cost = torch.where(both_valid, cost, torch.full_like(cost, 2 * INF))
    # dynamic k: clamp(int(sum of the top-10 IoUs), 1)
    sel_k = min(candidate_topk, n)
    top_ious = torch.sort(ious.t(), dim=1, descending=True,
                          stable=True).values[:, :sel_k]
    dyn_ks = top_ious.sum(-1).to(torch.int32).clamp(min=1)
    matching = (_rank_smallest(cost, 0) < dyn_ks[None, :]) & both_valid
    # a prior matched to several GTs keeps the cheapest
    multi = matching.sum(dim=1) > 1
    argmin_cost = torch.argmin(torch.where(
        gt_valid[None, :], cost, torch.full_like(cost, float('inf'))), dim=1)
    keep_one = F.one_hot(argmin_cost, k).bool()
    matching = torch.where(multi[:, None], matching & keep_one, matching)
    fg = matching.any(dim=1)
    arg = torch.argmax(matching.to(torch.uint8), dim=1)
    assigned = torch.where(fg, arg + 1, torch.zeros_like(arg))
    matched_iou = (matching * ious).sum(dim=1)
    max_ov = torch.where(fg, matched_iou, torch.full_like(matched_iou, -INF))
    return assigned, max_ov, labels_of(assigned, gt_labels)


def approx_max_iou_assign(approxs: torch.Tensor,
                          squares: torch.Tensor,
                          approxs_per_octave: int,
                          gt_bboxes: torch.Tensor,
                          gt_valid: torch.Tensor,
                          pos_iou_thr: float = 0.5,
                          neg_iou_thr=0.4,
                          min_pos_iou: float = 0.0,
                          gt_max_assign_all: bool = True,
                          match_low_quality: bool = True,
                          gt_bboxes_ignore: Optional[torch.Tensor] = None,
                          ignore_valid: Optional[torch.Tensor] = None,
                          ignore_iof_thr: float = -1.0,
                          ignore_wrt_candidates: bool = True,
                          gt_labels: Optional[torch.Tensor] = None):
    """GuidedAnchoring ApproxMaxIoUAssigner (reference
    approx_max_iou_assigner.py:60-146): the max IoU over each square's
    ``approxs_per_octave`` approximations, then plain MaxIoU."""
    num_squares = squares.shape[0]
    ov = bbox_overlaps(approxs.reshape(-1, 4), gt_bboxes)
    overlaps = ov.reshape(num_squares, approxs_per_octave, -1).amax(1).t()
    neg1 = torch.full_like(overlaps, -1.0)
    overlaps = torch.where(gt_valid[:, None], overlaps, neg1)
    if ignore_iof_thr > 0 and gt_bboxes_ignore is not None:
        if ignore_wrt_candidates:
            iof = bbox_overlaps(squares, gt_bboxes_ignore, mode='iof')
            if ignore_valid is not None:
                iof = torch.where(ignore_valid[None, :], iof,
                                  torch.zeros_like(iof))
            ign = iof.amax(dim=1) > ignore_iof_thr
        else:
            iof = bbox_overlaps(gt_bboxes_ignore, squares, mode='iof')
            if ignore_valid is not None:
                iof = torch.where(ignore_valid[:, None], iof,
                                  torch.zeros_like(iof))
            ign = iof.amax(dim=0) > ignore_iof_thr
        overlaps = torch.where(ign[None, :], neg1, overlaps)
    return assign_wrt_overlaps(
        overlaps, gt_valid, pos_iou_thr=pos_iou_thr,
        neg_iou_thr=neg_iou_thr, min_pos_iou=min_pos_iou,
        gt_max_assign_all=gt_max_assign_all,
        match_low_quality=match_low_quality, gt_labels=gt_labels)


def focal_loss_cost(cls_pred: torch.Tensor, gt_labels: torch.Tensor,
                    weight: float = 1.0, alpha: float = 0.25,
                    gamma: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """FocalLossCost (reference match_cost.py:64-92, binary_input=False):
    the positive minus the negative focal cost at the GT class."""
    p = torch.sigmoid(cls_pred)
    neg_cost = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos_cost = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    idx = gt_labels.clamp(min=0).long()
    return (pos_cost[:, idx] - neg_cost[:, idx]) * weight


def bbox_l1_cost(bbox_pred: torch.Tensor, gt_bboxes: torch.Tensor,
                 weight: float = 1.0) -> torch.Tensor:
    """BBoxL1Cost (reference match_cost.py:11-38)."""
    return torch.abs(bbox_pred[:, None, :] - gt_bboxes[None, :, :]).sum(-1) \
        * weight


def iou_cost(bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
             weight: float = 1.0, mode: str = 'giou') -> torch.Tensor:
    """IoUCost (reference match_cost.py:95-125): -IoU / -GIoU pairwise."""
    q, g = bboxes.shape[0], gt_bboxes.shape[0]
    return -aligned_iou(bboxes[:, None, :].expand(q, g, 4),
                        gt_bboxes[None, :, :].expand(q, g, 4),
                        mode=mode) * weight


def dice_cost(mask_preds: torch.Tensor, gt_masks: torch.Tensor,
              weight: float = 1.0, pred_act: bool = True,
              eps: float = 1e-3, naive_dice: bool = True) -> torch.Tensor:
    """DiceCost (reference match_cost.py:200-258): pairwise soft-dice cost
    between (q, ...) predicted and (g, ...) GT masks."""
    p = torch.sigmoid(mask_preds) if pred_act else mask_preds
    p = p.reshape(p.shape[0], -1)
    t = gt_masks.reshape(gt_masks.shape[0], -1).to(p.dtype)
    num = 2 * torch.einsum('ql,gl->qg', p, t)
    if naive_dice:
        den = p.sum(-1)[:, None] + t.sum(-1)[None, :]
    else:
        den = (p * p).sum(-1)[:, None] + (t * t).sum(-1)[None, :]
    return -((num + eps) / (den + eps)) * weight


def hungarian_bbox_assign(bbox_pred: torch.Tensor,
                          cls_pred: torch.Tensor,
                          gt_bboxes: torch.Tensor,
                          gt_valid: torch.Tensor,
                          gt_labels: torch.Tensor,
                          img_shape,
                          cls_weight: float = 1.0,
                          reg_weight: float = 1.0,
                          iou_weight: float = 1.0,
                          iou_mode: str = 'giou'):
    """DETR's box HungarianAssigner (reference hungarian_assigner.py:
    60-146): FocalLossCost + L1 on normalised (cx, cy, w, h) + GIoU cost,
    solved by ``solve_lsa`` on the device. ``bbox_pred`` is normalised
    (cx, cy, w, h)."""
    img_h, img_w = img_shape[0], img_shape[1]
    factor = torch.tensor([img_w, img_h, img_w, img_h],
                          dtype=bbox_pred.dtype, device=bbox_pred.device)
    cls_cost = focal_loss_cost(cls_pred, gt_labels) * cls_weight
    reg_cost = bbox_l1_cost(bbox_pred, gt_bboxes / factor) * reg_weight
    cx, cy, w, h = bbox_pred.unbind(-1)
    pred_xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                             cy + h / 2], -1) * factor
    i_cost = iou_cost(pred_xyxy, gt_bboxes, mode=iou_mode) * iou_weight
    cost = cls_cost + reg_cost + i_cost
    cost = torch.where(gt_valid[None, :], cost, torch.full_like(cost, 1e9))
    # every (padded) GT row gets a query; the padded GTs' are dropped
    q_of_gt = solve_lsa(cost.t())                          # (k,)
    gidx = torch.arange(1, gt_valid.shape[0] + 1, device=cost.device)
    assigned = torch.zeros((bbox_pred.shape[0],), dtype=torch.long,
                           device=cost.device).scatter_reduce(
        0, q_of_gt, torch.where(gt_valid, gidx, torch.zeros_like(gidx)),
        'amax')
    return assigned, None, labels_of(assigned, gt_labels)
