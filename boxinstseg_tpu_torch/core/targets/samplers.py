"""The box-sampler zoo, counterpart of
``boxinstseg_tpu/core/targets/samplers.py`` (reference:
mmdet/core/bbox/samplers/{instance_balanced_pos,iou_balanced_neg,ohem,
score_hlr,combined}_sampler.py).

Every sampler returns fixed-shape boolean masks (and per-sample weights
where the reference makes them), with a randomised top-k in place of
``random_choice``. The draws are split from the selection: a sampler takes
its (n,) uniforms as ``noise``, in the order the JAX function draws them
(its docstring says which), or draws them from ``generator``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ...ops.boxes import aligned_iou
from .assigners import uniform_noise


def _ranks(score: torch.Tensor) -> torch.Tensor:
    """Each entry's 0-based place in a stable ascending sort."""
    return torch.argsort(torch.argsort(score, stable=True), stable=True)


def _rand_topk_mask(mask: torch.Tensor, limit,
                    noise: torch.Tensor) -> torch.Tensor:
    """Keep at most ``limit`` True entries of ``mask``: those with the
    largest uniforms of ``noise`` (n,)."""
    score = torch.where(mask, noise, torch.full_like(noise, -1.0))
    return mask & (_ranks(-score) < limit)


def _group_ranks(keys: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    """The place of each entry within its run of equal ``group`` after a
    stable sort by ``keys``: the JAX package's segment-start scan."""
    n = keys.shape[0]
    order = torch.argsort(keys, stable=True)
    sg = group[order]
    posidx = torch.arange(n, device=keys.device)
    start = torch.ones(n, dtype=torch.bool, device=keys.device)
    start[1:] = sg[1:] != sg[:-1]
    seg_start = torch.cummax(torch.where(start, posidx,
                                         torch.full_like(posidx, -1)),
                             dim=0).values
    ranks = torch.empty_like(posidx)
    ranks[order] = posidx - seg_start
    return ranks


def instance_balanced_pos_sample(assigned: torch.Tensor, num_expected: int,
                                 max_gts: Optional[int] = None,
                                 generator: Optional[torch.Generator] = None,
                                 noise: Optional[Sequence[torch.Tensor]]
                                 = None) -> torch.Tensor:
    """InstanceBalancedPosSampler (reference
    instance_balanced_pos_sampler.py:20-55): each GT's positives capped at
    round(num_expected / num_gts) + 1, then topped up at random from the
    other positives. ``noise``: the in-group ranks' uniforms, the top-up's
    and the final trim's."""
    pos = assigned > 0
    n = assigned.shape[0]
    if noise is None:
        noise = uniform_noise(3, n, generator, assigned.device)
    num_pos = pos.sum()
    if max_gts is None:
        max_gts = n
    gt_ids = torch.where(pos, assigned, torch.zeros_like(assigned)).long()
    counts = torch.zeros((max_gts + 1,), dtype=torch.long,
                         device=assigned.device).index_add_(
        0, gt_ids.clamp(0, max_gts), pos.long())
    num_gts = (counts[1:] > 0).sum().clamp(min=1)
    per_gt = torch.round(num_expected / num_gts.float()).long() + 1
    key_sort = torch.where(pos, gt_ids.float() * 2.0 + noise[0],
                           torch.full_like(noise[0], 1e9))
    rank_in_group = _group_ranks(key_sort, gt_ids)
    keep = pos & (rank_in_group < per_gt)
    short = num_expected - keep.sum()
    keep = keep | _rand_topk_mask(pos & ~keep, short.clamp(min=0), noise[1])
    keep = _rand_topk_mask(keep, torch.clamp(num_pos, max=num_expected),
                           noise[2])
    return torch.where(num_pos <= num_expected, pos, keep)


def iou_balanced_neg_sample(assigned: torch.Tensor,
                            max_overlaps: torch.Tensor,
                            num_expected: int,
                            floor_thr: float = -1.0,
                            floor_fraction: float = 0.0,
                            num_bins: int = 3,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[Sequence[torch.Tensor]] = None
                            ) -> torch.Tensor:
    """IoUBalancedNegSampler (reference iou_balanced_neg_sampler.py:
    25-157): negatives binned by their max IoU and sampled evenly per bin
    (the floor region apart), topped up at random. ``noise``: one (n,)
    draw a bin, then the floor's and the top-up's (num_bins + 2)."""
    neg = assigned == 0
    n = assigned.shape[0]
    if noise is None:
        noise = uniform_noise(num_bins + 2, n, generator, assigned.device)
    num_neg = neg.sum()
    if floor_thr > 0:
        floor = neg & (max_overlaps >= 0) & (max_overlaps < floor_thr)
        iou_set = neg & (max_overlaps >= floor_thr)
        ft = floor_thr
    elif floor_thr == 0:
        floor = neg & (max_overlaps == 0)
        iou_set = neg & (max_overlaps > 0)
        ft = 0.0
    else:
        floor = torch.zeros_like(neg)
        iou_set = neg
        ft = 0.0
    num_iou_exp = int(num_expected * (1 - floor_fraction))
    interval = (max_overlaps.max() - ft) / num_bins
    per_bin = num_iou_exp // num_bins
    picked = torch.zeros_like(neg)
    for i in range(num_bins):
        lo = ft + i * interval
        hi = ft + (i + 1) * interval
        in_bin = iou_set & (max_overlaps >= lo) & (max_overlaps < hi)
        picked = picked | _rand_topk_mask(in_bin, per_bin, noise[i])
    num_floor = num_expected - picked.sum()
    picked = picked | _rand_topk_mask(floor, num_floor.clamp(min=0),
                                      noise[num_bins])
    short = num_expected - picked.sum()
    picked = picked | _rand_topk_mask(neg & ~picked, short.clamp(min=0),
                                      noise[num_bins + 1])
    return torch.where(num_neg <= num_expected, neg, picked)


def ohem_sample(assigned: torch.Tensor, loss: torch.Tensor, num: int,
                pos_fraction: float, neg_pos_ub: float = -1.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OHEMSampler (reference ohem_sampler.py:40-110): the highest-loss
    positives and negatives, by the head's own per-sample loss."""
    def hard(mask, limit):
        s = torch.where(mask, loss, torch.full_like(loss, -float('inf')))
        return mask & (_ranks(-s) < limit)

    pos = hard(assigned > 0, int(num * pos_fraction))
    num_neg = num - pos.sum()
    if neg_pos_ub >= 0:
        num_neg = torch.minimum(num_neg,
                                (pos.sum() * neg_pos_ub).to(num_neg.dtype))
    return pos, hard(assigned == 0, num_neg)


def nms_match_groups(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, iou_thr: float) -> torch.Tensor:
    """mmcv ``nms_match`` as group ids: each box joins the first
    (highest-score) greedy-NMS survivor that overlaps it by more than
    iou_thr; survivors lead their own groups. Returns (n,) int64 group ids
    (the index of the group's seed), -1 for invalid boxes."""
    n = boxes.shape[0]
    dev = boxes.device
    order = torch.argsort(torch.where(valid, -scores,
                                      torch.full_like(scores, float('inf'))),
                          stable=True)
    b = boxes[order]
    ious = aligned_iou(b[:, None, :].expand(n, n, 4),
                       b[None, :, :].expand(n, n, 4))
    v = valid[order]
    idx = torch.arange(n, device=dev)
    keep = torch.zeros(n, dtype=torch.bool, device=dev)
    seed = torch.full((n,), -1, dtype=torch.long, device=dev)
    for i in range(n):
        # box i is suppressed by the first kept j < i with IoU > thr
        sup = (idx < i) & keep & (ious[i] > iou_thr) & v
        has = sup.any()
        j = torch.argmax(sup.to(torch.uint8))
        keep[i] = v[i] & ~has
        seed[i] = torch.where(has, seed[j], idx[i])
    group = torch.full((n,), -1, dtype=torch.long, device=dev)
    group[order] = torch.where(v, order[seed.clamp(min=0)],
                               torch.full_like(seed, -1))
    return group


def score_hlr_neg_sample(assigned: torch.Tensor,
                         max_score: torch.Tensor,
                         pred_boxes: torch.Tensor,
                         num_expected: int,
                         score_thr: float = 0.05,
                         iou_thr: float = 0.5,
                         k: float = 0.5,
                         bias: float = 0.0,
                         ori_loss: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[Sequence[torch.Tensor]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ScoreHLRSampler negatives (reference score_hlr_sampler.py:101-215):
    valid (score > thr) negatives grouped by NMS-match on their decoded
    boxes, ranked in their group by score and then globally (Score-HLR),
    the hardest kept, the rest filled at random from the invalid ones;
    label weights from the HLR, renormalised against ``ori_loss``.
    ``noise``: the fill's and the no-valid fallback's uniforms. Returns
    (selected mask, (n,) label weights)."""
    neg = assigned == 0
    n = assigned.shape[0]
    if noise is None:
        noise = uniform_noise(2, n, generator, assigned.device)
    valid = neg & (max_score > score_thr)
    invalid = neg & ~valid
    num_valid = valid.sum()

    group = nms_match_groups(pred_boxes, max_score, valid, iou_thr)
    gkey = torch.where(valid, group.float(),
                       torch.full_like(max_score, float('inf')))
    # jnp.lexsort((-score, gkey)): by group, then by score descending
    by_score = torch.argsort(-max_score, stable=True)
    order2 = by_score[torch.argsort(gkey[by_score], stable=True)]
    ranks = torch.empty_like(order2)
    ranks[order2] = torch.arange(n, device=order2.device)
    rank_in_group = _group_ranks(ranks.float(), group).float()

    ninf = torch.full_like(max_score, -float('inf'))
    imp = torch.where(valid, num_valid.float() - rank_in_group + max_score,
                      ninf)
    imp_rank = _ranks(-imp).float()                        # 0 = hardest
    hlr_keep = valid & (imp_rank < num_expected)
    rand_fill = _rand_topk_mask(
        invalid, (num_expected - hlr_keep.sum()).clamp(min=0), noise[0])
    select = hlr_keep | rand_fill

    up_bound = torch.clamp(num_valid.float(), min=float(num_expected))
    w_hlr = (up_bound - imp_rank) / up_bound
    inf = torch.full_like(w_hlr, float('inf'))
    min_w = torch.where(num_valid > 0,
                        torch.where(hlr_keep, w_hlr, inf).min(),
                        torch.ones((), device=w_hlr.device))
    zeros = torch.zeros_like(w_hlr)
    weights = torch.where(hlr_keep, w_hlr,
                          torch.where(rand_fill, min_w, zeros))
    weights = torch.where(select, (bias + (1 - bias) * weights) ** k, zeros)
    if ori_loss is not None:
        ori = (ori_loss * select).sum()
        new = (ori_loss * weights).sum()
        weights = weights * ori / new.clamp(min=1e-12)
    # no valid negatives: uniform weights on a random pick
    fallback = _rand_topk_mask(neg, num_expected, noise[1])
    weights = torch.where(num_valid > 0, weights, fallback.float())
    select = torch.where(num_valid > 0, select, fallback)
    return select, weights


def combined_sample(assigned: torch.Tensor, max_overlaps: torch.Tensor,
                    num: int, pos_fraction: float, floor_thr: float = -1.0,
                    floor_fraction: float = 0.0, num_bins: int = 3,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Tuple[Sequence[torch.Tensor],
                                          Sequence[torch.Tensor]]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CombinedSampler as Libra R-CNN ships it (reference
    combined_sampler.py: InstanceBalancedPosSampler +
    IoUBalancedNegSampler). ``noise``: the two samplers' draws."""
    pos_noise, neg_noise = noise if noise is not None else (None, None)
    pos = instance_balanced_pos_sample(
        assigned, int(num * pos_fraction), generator=generator,
        noise=pos_noise)
    neg = iou_balanced_neg_sample(
        assigned, max_overlaps, num - int(num * pos_fraction), floor_thr,
        floor_fraction, num_bins, generator=generator, noise=neg_noise)
    return pos, neg
