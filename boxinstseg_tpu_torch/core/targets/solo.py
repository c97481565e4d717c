"""SOLOv2 grid target assignment with static shapes, counterpart of
``boxinstseg_tpu/core/targets/solo.py`` (reference: box_solov2_head.py:
395-477 and discobox_head.py:1442-1529).

A GT is assigned to every grid cell within +-1 of its mass-centre cell,
intersected with the sigma-shrunk box extent, on each level whose scale
range holds sqrt(area). The centre of mass comes from the stride-4 GT
masks. Where several GTs claim a cell the last one wins (the largest GT
index), as the reference's loop overwrites.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


class SoloTargets(NamedTuple):
    cate_labels: torch.Tensor   # (B, Pc) int64 label per cell (bg = C)
    cell_gt: torch.Tensor       # (B, Pc) int64 assigned GT slot (-1 none)
    num_pos: torch.Tensor       # () positive cells in the batch
    level_ids: torch.Tensor     # (Pc,) level of each flattened cell


def mask_centers_areas(gt_masks: torch.Tensor, mask_stride: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, G, Hs, Ws) masks -> mass centres (y, x) in canvas coordinates and
    areas at full resolution (approximately: the masks are subsampled)."""
    m = gt_masks.float()
    hs, ws = m.shape[2], m.shape[3]
    ys = torch.arange(hs, dtype=torch.float32, device=m.device) * mask_stride
    xs = torch.arange(ws, dtype=torch.float32, device=m.device) * mask_stride
    tot = m.sum(dim=(2, 3))
    cy = (m.sum(dim=3) * ys).sum(dim=2) / torch.clamp(tot, min=1e-6)
    cx = (m.sum(dim=2) * xs).sum(dim=2) / torch.clamp(tot, min=1e-6)
    return cy, cx, tot * (mask_stride ** 2)


def solo_targets(gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
                 gt_valid: torch.Tensor, gt_masks: torch.Tensor,
                 canvas_hw: Tuple[int, int], num_grids: Sequence[int],
                 scale_ranges: Sequence[Tuple[float, float]], sigma: float,
                 num_classes: int, mask_stride: int = 4,
                 min_mask_area: float = 10.0) -> SoloTargets:
    """All-level grid assignment; cells are flattened level-major and
    row-major within a level, the reference's per-level concatenation."""
    b, g = gt_labels.shape
    h, w = canvas_hw
    dev = gt_bboxes.device
    cy, cx, mask_area = mask_centers_areas(gt_masks, mask_stride)
    gw = gt_bboxes[..., 2] - gt_bboxes[..., 0]
    gh = gt_bboxes[..., 3] - gt_bboxes[..., 1]
    gt_scale = torch.sqrt(torch.clamp(gw * gh, min=0.0))
    half_w = 0.5 * gw * sigma
    half_h = 0.5 * gh * sigma
    gt_ids = torch.arange(g, device=dev)
    cates, gts, levels = [], [], []
    for lvl, (s, (lo, hi)) in enumerate(zip(num_grids, scale_ranges)):
        hit = (gt_scale >= lo) & (gt_scale <= hi) & gt_valid.bool() \
            & (mask_area >= min_mask_area)

        def cell_of(coord, size):
            return torch.floor(coord / size * s).long()

        ci = cell_of(cy, h)
        cj = cell_of(cx, w)
        top = torch.maximum(torch.clamp(cell_of(cy - half_h, h), min=0),
                            ci - 1)
        down = torch.minimum(torch.clamp(cell_of(cy + half_h, h),
                                         max=s - 1), ci + 1)
        left = torch.maximum(torch.clamp(cell_of(cx - half_w, w), min=0),
                             cj - 1)
        right = torch.minimum(torch.clamp(cell_of(cx + half_w, w),
                                          max=s - 1), cj + 1)
        ii = torch.arange(s, device=dev)[None, :, None, None]
        jj = torch.arange(s, device=dev)[None, None, :, None]
        in_cell = ((ii >= top[:, None, None, :])
                   & (ii <= down[:, None, None, :])
                   & (jj >= left[:, None, None, :])
                   & (jj <= right[:, None, None, :])
                   & hit[:, None, None, :])                      # (B,S,S,G)
        best = torch.where(in_cell, gt_ids, -1).amax(dim=-1)     # (B,S,S)
        lbl = torch.gather(gt_labels.long(), 1,
                           torch.clamp(best, min=0).reshape(b, -1))
        lbl = torch.where(best.reshape(b, -1) >= 0, lbl, num_classes)
        cates.append(lbl)
        gts.append(best.reshape(b, s * s))
        levels.append(np.full(s * s, lvl, np.int64))
    cell_gt = torch.cat(gts, dim=1)
    return SoloTargets(cate_labels=torch.cat(cates, dim=1), cell_gt=cell_gt,
                       num_pos=(cell_gt >= 0).sum(),
                       level_ids=torch.from_numpy(np.concatenate(levels))
                       .to(dev))


def sample_positive_cells(cell_gt: torch.Tensor, capacity: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Up to ``capacity`` positive cells per image, in cell order (the
    reference keeps every positive; the fixed capacity is the static-shape
    trade-off). The sort keys are unique, so the order is the JAX
    package's. Returns (cell_idx (B, K), gt_idx (B, K), valid (B, K))."""
    _, pc = cell_gt.shape
    pos = cell_gt >= 0
    idx = torch.arange(pc, device=cell_gt.device)[None, :]
    key = torch.where(pos, idx, pc + idx)
    order = torch.argsort(key, dim=1, stable=True)[:, :capacity]
    valid = torch.gather(pos, 1, order)
    gt_idx = torch.gather(cell_gt, 1, order)
    cell_idx = torch.where(valid, order, 0)
    gt_idx = torch.where(valid, gt_idx, 0)
    return cell_idx, gt_idx, valid
