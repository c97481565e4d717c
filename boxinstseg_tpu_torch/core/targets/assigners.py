"""Box-IoU assignment and the plain samplers, counterpart of
``boxinstseg_tpu/core/targets/assigners.py`` (reference:
mmdet/core/bbox/assigners/max_iou_assigner.py and
mmdet/core/bbox/samplers/{pseudo,random}_sampler.py).

Fixed shapes with validity masks, as in the JAX package: the GTs are a
padded (K, 4) with a (K,) valid mask; the low-quality overwrite loop is a
"largest eligible GT wins" reduction (the reference's ascending loop has
that overwrite order, max_iou_assigner.py:199-205). Random draws are split
from what follows them: a sampler takes its uniforms as ``noise`` (the JAX
function's draws in its order), or draws them from ``generator``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch


def bbox_overlaps(b1: torch.Tensor, b2: torch.Tensor, mode: str = 'iou',
                  eps: float = 1e-6) -> torch.Tensor:
    """(n, 4) x (k, 4) xyxy -> (n, k) IoU, or IoF (intersection over b1);
    areas are not clamped, as in the JAX function."""
    lt = torch.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = torch.minimum(b1[:, None, 2:4], b2[None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    union = a1[:, None] + a2[None, :] - inter if mode == 'iou' \
        else a1[:, None].expand(inter.shape)
    return inter / union.clamp(min=eps)


def uniform_noise(count: int, n: int, generator: Optional[torch.Generator],
                  device) -> Tuple[torch.Tensor, ...]:
    """``count`` (n,) uniform draws on ``device``, from ``generator``
    (drawn on the generator's device, then moved)."""
    gdev = generator.device if generator is not None else device
    u = torch.rand((count, n), generator=generator, device=gdev)
    return tuple(u.to(device))


def labels_of(assigned: torch.Tensor, gt_labels: Optional[torch.Tensor]):
    """The assigned GT's label, -1 where nothing positive is assigned."""
    if gt_labels is None:
        return None
    picked = gt_labels[(assigned - 1).clamp(min=0)].long()
    return torch.where(assigned > 0, picked, torch.full_like(picked, -1))


def max_iou_assign(bboxes: torch.Tensor,
                   gt_bboxes: torch.Tensor,
                   gt_valid: torch.Tensor,
                   pos_iou_thr: float = 0.5,
                   neg_iou_thr: Union[float, Tuple[float, float]] = 0.5,
                   min_pos_iou: float = 0.0,
                   gt_max_assign_all: bool = True,
                   match_low_quality: bool = True,
                   gt_bboxes_ignore: Optional[torch.Tensor] = None,
                   ignore_valid: Optional[torch.Tensor] = None,
                   ignore_iof_thr: float = -1.0,
                   gt_labels: Optional[torch.Tensor] = None):
    """Returns (assigned_gt_inds (n,) int64 with -1 ignore / 0 negative /
    g+1 positive, max_overlaps (n,), assigned_labels (n,) or None)."""
    overlaps = bbox_overlaps(gt_bboxes, bboxes)          # (k, n)
    overlaps = torch.where(gt_valid[:, None], overlaps,
                           torch.full_like(overlaps, -1.0))
    if ignore_iof_thr > 0 and gt_bboxes_ignore is not None:
        # ignored candidates' columns go to -1 before any assignment
        # (max_iou_assigner.py:113-127)
        iof = bbox_overlaps(bboxes, gt_bboxes_ignore, mode='iof')
        if ignore_valid is not None:
            iof = torch.where(ignore_valid[None, :], iof,
                              torch.zeros_like(iof))
        overlaps = torch.where((iof.amax(dim=1) > ignore_iof_thr)[None, :],
                               torch.full_like(overlaps, -1.0), overlaps)
    return assign_wrt_overlaps(
        overlaps, gt_valid, pos_iou_thr=pos_iou_thr,
        neg_iou_thr=neg_iou_thr, min_pos_iou=min_pos_iou,
        gt_max_assign_all=gt_max_assign_all,
        match_low_quality=match_low_quality, gt_labels=gt_labels)


def largest_claim(claim: torch.Tensor) -> torch.Tensor:
    """(k, n) claims -> (n,) the largest claiming GT + 1, 0 for none."""
    gid = torch.arange(1, claim.shape[0] + 1, device=claim.device)
    return torch.where(claim, gid[:, None], torch.zeros_like(gid)[:, None]
                       ).amax(dim=0)


def assign_wrt_overlaps(overlaps: torch.Tensor,
                        gt_valid: torch.Tensor,
                        pos_iou_thr: float = 0.5,
                        neg_iou_thr: Union[float, Tuple[float, float]] = 0.5,
                        min_pos_iou: float = 0.0,
                        gt_max_assign_all: bool = True,
                        match_low_quality: bool = True,
                        gt_labels: Optional[torch.Tensor] = None):
    """MaxIoU assignment from a (k, n) overlap matrix whose ignored columns
    are already -1 (reference max_iou_assigner.py:149-218; also the tail
    of ApproxMaxIoUAssigner)."""
    n = overlaps.shape[1]
    # argmax: the first index of the largest, as jnp.argmax
    max_overlaps, argmax_overlaps = overlaps.amax(0), overlaps.argmax(0)
    gt_max, gt_argmax = overlaps.amax(1), overlaps.argmax(1)

    assigned = torch.full((n,), -1, dtype=torch.long,
                          device=overlaps.device)
    if isinstance(neg_iou_thr, tuple):
        neg = (max_overlaps >= neg_iou_thr[0]) & \
            (max_overlaps < neg_iou_thr[1])
    else:
        neg = (max_overlaps >= 0) & (max_overlaps < neg_iou_thr)
    assigned = torch.where(neg, torch.zeros_like(assigned), assigned)
    pos = max_overlaps >= pos_iou_thr
    assigned = torch.where(pos, argmax_overlaps + 1, assigned)

    if match_low_quality:
        # the largest eligible GT wins (the reference's ascending loop)
        gt_ok = gt_valid & (gt_max >= min_pos_iou)
        if gt_max_assign_all:
            claim = overlaps == gt_max[:, None]
        else:
            claim = torch.zeros_like(overlaps, dtype=torch.bool)
            claim[torch.arange(overlaps.shape[0],
                               device=overlaps.device), gt_argmax] = True
        best = largest_claim(claim & gt_ok[:, None])
        assigned = torch.where(best > 0, best, assigned)
    return assigned, max_overlaps.clamp(min=0.0), \
        labels_of(assigned, gt_labels)


def pseudo_sample(assigned: torch.Tensor):
    """PseudoSampler: every positive and negative kept (reference
    mask_pseudo_sampler.py): boolean pos / neg masks."""
    return assigned > 0, assigned == 0


def _pick(mask: torch.Tensor, noise: torch.Tensor, limit) -> torch.Tensor:
    """At most ``limit`` True entries of ``mask``: those whose uniform
    draw reaches the limit-th largest among the mask's."""
    n = mask.shape[0]
    score = torch.where(mask, noise, torch.full_like(noise, -1.0))
    count = mask.sum()
    limit = torch.as_tensor(limit, device=mask.device)
    thresh_idx = (torch.minimum(limit, count.clamp(min=1)) - 1).clamp(
        0, n - 1)
    kth = torch.sort(score, descending=True).values[thresh_idx]
    ok = (count > 0) & (limit > 0)
    return mask & (score >= torch.where(ok, kth, torch.full_like(kth, 2.0)))


def random_sample(assigned: torch.Tensor, num: int, pos_fraction: float,
                  neg_pos_ub: float = -1.0,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Sequence[torch.Tensor]] = None):
    """RandomSampler with a static output size: boolean masks of at most
    num * pos_fraction positives and num - #pos negatives, uniformly
    (reference random_sampler.py). ``noise``: the (n,) uniforms of the
    positives and of the negatives."""
    n = assigned.shape[0]
    if noise is None:
        noise = uniform_noise(2, n, generator, assigned.device)
    pos = _pick(assigned > 0, noise[0], int(num * pos_fraction))
    num_neg = num - pos.sum()
    if neg_pos_ub >= 0:
        num_neg = torch.minimum(num_neg,
                                (pos.sum() * neg_pos_ub).to(num_neg.dtype))
    neg = _pick(assigned == 0, noise[1], num_neg)
    return pos, neg
