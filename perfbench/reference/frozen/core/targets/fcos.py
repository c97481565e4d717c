"""Batched FCOS point-target assignment and fixed-capacity positive
sampling, counterpart of ``boxinstseg_tpu/core/targets/fcos.py``
(reference: condinst_head.py:550-633 _get_target_single and 1186-1232).

Padded GT slots carry a validity mask and are excluded by pushing their
area to INF, as the reference pushes non-matching candidates to INF before
the min-area argmin.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

INF = 1e8


class FcosTargets(NamedTuple):
    labels: torch.Tensor        # (B, P) int64 in [0, num_classes]; bg = num_classes
    bbox_targets: torch.Tensor  # (B, P, 4) l,t,r,b (divided by stride if norm_on_bbox)
    gt_inds: torch.Tensor       # (B, P) int64 GT slot; -1 = bg
    centerness: torch.Tensor    # (B, P) centerness target (0 where bg)


def centerness_target(bbox_targets: torch.Tensor) -> torch.Tensor:
    """sqrt((min_lr/max_lr) * (min_tb/max_tb)) (reference
    condinst_head.py:855-876)."""
    lr = bbox_targets[..., [0, 2]]
    tb = bbox_targets[..., [1, 3]]
    ctr = (lr.amin(-1) / lr.amax(-1).clamp(min=1e-12)) * (
        tb.amin(-1) / tb.amax(-1).clamp(min=1e-12))
    return torch.sqrt(ctr.clamp(min=0.0))


def fcos_targets(points: torch.Tensor,
                 strides: torch.Tensor,
                 regress_ranges: torch.Tensor,
                 gt_bboxes: torch.Tensor,
                 gt_labels: torch.Tensor,
                 gt_valid: torch.Tensor,
                 num_classes: int,
                 center_sampling: bool = True,
                 center_sample_radius: float = 1.5,
                 norm_on_bbox: bool = True) -> FcosTargets:
    """Assign each point of each image to a GT (or background).

    Args:
      points: (P, 2) xy; strides: (P,); regress_ranges: (P, 2).
      gt_bboxes: (B, G, 4) xyxy in input-canvas coords.
      gt_labels: (B, G) int; gt_valid: (B, G) bool (padded slots False).
    """
    B, G = gt_labels.shape
    P = points.shape[0]
    xs = points[:, 0][None, :, None]            # (1, P, 1)
    ys = points[:, 1][None, :, None]
    gx1 = gt_bboxes[:, None, :, 0]              # (B, 1, G)
    gy1 = gt_bboxes[:, None, :, 1]
    gx2 = gt_bboxes[:, None, :, 2]
    gy2 = gt_bboxes[:, None, :, 3]

    left = xs - gx1                              # (B, P, G)
    right = gx2 - xs
    top = ys - gy1
    bottom = gy2 - ys

    if center_sampling:
        cx = (gx1 + gx2) / 2
        cy = (gy1 + gy2) / 2
        r = (strides * center_sample_radius)[None, :, None]
        cb_x1 = torch.maximum(cx - r, gx1)
        cb_y1 = torch.maximum(cy - r, gy1)
        cb_x2 = torch.minimum(cx + r, gx2)
        cb_y2 = torch.minimum(cy + r, gy2)
        inside = torch.minimum(
            torch.minimum(xs - cb_x1, cb_x2 - xs),
            torch.minimum(ys - cb_y1, cb_y2 - ys)) > 0
    else:
        inside = torch.minimum(torch.minimum(left, right),
                               torch.minimum(top, bottom)) > 0

    max_dist = torch.maximum(torch.maximum(left, right),
                             torch.maximum(top, bottom))
    rr = regress_ranges[None, :, :]              # (1, P, 2)
    in_range = (max_dist >= rr[..., 0:1]) & (max_dist <= rr[..., 1:2])

    areas = ((gx2 - gx1) * (gy2 - gy1)).expand(B, P, G)
    bad = (~inside) | (~in_range) | (~gt_valid[:, None, :])
    areas = torch.where(bad, torch.full_like(areas, INF), areas)

    min_area, min_inds = areas.min(dim=-1)       # first index on ties
    is_bg = min_area >= INF

    gt_inds = torch.where(is_bg, torch.full_like(min_inds, -1), min_inds)
    labels = torch.gather(gt_labels.long(), 1, min_inds)
    labels = torch.where(is_bg, torch.full_like(labels, num_classes), labels)
    pick = lambda t: torch.gather(t, 2, min_inds[..., None])[..., 0]  # noqa
    bt = torch.stack([pick(left), pick(top), pick(right), pick(bottom)],
                     dim=-1)                     # (B, P, 4)
    ctr = torch.where(is_bg, torch.zeros_like(min_area),
                      centerness_target(bt))
    if norm_on_bbox:
        bt = bt / strides[None, :, None]
    return FcosTargets(labels=labels, bbox_targets=bt, gt_inds=gt_inds,
                       centerness=ctr)


def sample_positives_per_gt(scores: torch.Tensor,
                            gt_inds: torch.Tensor,
                            gt_valid: torch.Tensor,
                            capacity: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Fixed-capacity positive sampling, reference-faithful
    (condinst_head.py:1186-1232 topk_per_img branch).

    Per image each GT contributes at most ``max(capacity // num_gts, 1)``
    positions, ranked by score; every GT's best position gets a slot before
    the remaining slots are filled in global score order. Both sorts are
    stable and keyed as in the JAX package (descending score, ties by point
    index), so the sampled indices match it exactly.

    Args:
      scores: (B, P) ranking score; gt_inds: (B, P) from fcos_targets;
      gt_valid: (B, G) bool; capacity: K samples per image.
    Returns:
      point_idx (B, K) int64 into P; sample_gt (B, K) int64; valid (B, K).
    """
    B, P = scores.shape
    G = gt_valid.shape[1]
    K = capacity
    dev = scores.device

    onehot = gt_inds[..., None] == torch.arange(G, device=dev)  # (B, P, G)
    ok = (onehot & gt_valid[:, None, :]).any(-1)
    s = torch.where(ok, scores.float(),
                    torch.full_like(scores, -float('inf'), dtype=torch.float))
    gts = torch.where(ok, gt_inds, torch.zeros_like(gt_inds))
    neg_s, order = torch.sort(-s, dim=1, stable=True)
    pid_s = order
    gt_s = torch.gather(gts, 1, order)
    fin = neg_s < float('inf')

    # rank of each entry within its GT group
    oh_s = (gt_s[..., None] == torch.arange(G, device=dev)) & fin[..., None]
    cum = torch.cumsum(oh_s.long(), dim=1)
    r = torch.where(oh_s, cum, torch.zeros_like(cum)).sum(-1) - 1

    num_gts = gt_valid.sum(dim=1).clamp(min=1)                 # (B,)
    inst_per_gt = (K // num_gts).clamp(min=1)
    keep = fin & (r >= 0) & (r < inst_per_gt[:, None])
    rank0 = keep & (r == 0)

    # output slot: every GT's best candidate first (score order), then the
    # remaining kept candidates by score
    c0 = torch.cumsum(rank0.long(), dim=1)
    n0 = c0[:, -1:]
    c1 = torch.cumsum((keep & ~rank0).long(), dim=1)
    slot = torch.where(rank0, c0 - 1, n0 + c1 - 1)
    sel = keep & (slot < K)

    # compact to the first K slots with a second stable sort
    key2 = torch.where(sel, slot, torch.full_like(slot, P + K)).float()
    _, order2 = torch.sort(key2, dim=1, stable=True)
    kc = min(K, P)
    order2 = order2[:, :kc]
    point_idx = torch.gather(pid_s, 1, order2)
    sample_gt = torch.gather(gt_s, 1, order2)
    valid = torch.gather(sel, 1, order2)
    if kc < K:
        pad = (0, K - kc)
        point_idx = torch.nn.functional.pad(point_idx, pad)
        sample_gt = torch.nn.functional.pad(sample_gt, pad)
        valid = torch.nn.functional.pad(valid, pad)
    point_idx = torch.where(valid, point_idx, torch.zeros_like(point_idx))
    sample_gt = torch.where(valid, sample_gt, torch.zeros_like(sample_gt))
    return point_idx, sample_gt, valid
