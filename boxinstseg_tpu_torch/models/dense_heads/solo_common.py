"""What the SOLO-family heads share (DiscoBox's and BoxLevelset's), from
the mmdet reference's SOLOv2 heads: the coordinate channels, the dynamic
mask decode and the prediction (get_seg_single)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ...ops.nms import mask_matrix_nms, top_k


def coord_feat(b: int, h: int, w: int, device) -> torch.Tensor:
    """(B, 2, H, W): x then y, each a linspace over [-1, 1]."""
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)]
                       )[None].expand(b, 2, h, w)


def decode_masks(mask_feat: torch.Tensor, kernels: torch.Tensor
                 ) -> torch.Tensor:
    """mask_feat (B, E, H, W), kernels (B, K, E) -> (B, K, H, W)."""
    b, e, h, w = mask_feat.shape
    return torch.bmm(kernels, mask_feat.reshape(b, e, h * w)).reshape(
        b, -1, h, w)


def solo_get_seg(cates: torch.Tensor, kernels: torch.Tensor,
                 mask_feat: torch.Tensor, num_grids: Sequence[int],
                 strides: Sequence[int], score_thr: float, mask_thr: float,
                 filter_thr: float, nms_pre: int, max_per_img: int,
                 kernel: str = 'gaussian', sigma: float = 2.0
                 ) -> Dict[str, torch.Tensor]:
    """The SOLO family's prediction (reference get_seg_single): the top
    ``nms_pre`` (cell, class) scores of ``cates`` (B, Pc, C) over
    ``score_thr``, their masks decoded from ``kernels`` (B, Pc, E) and
    ``mask_feat`` (B, E, H, W), binarised at ``mask_thr`` and kept when
    larger than their level's stride, rescored by their mean mask score,
    matrix NMS, ``filter_thr``, then the top ``max_per_img``. Every
    selection is ``ops.nms.top_k`` (ties to the lower index). Returns
    scores, labels, valid (B, D) and masks (B, D, H, W) sigmoid scores at
    the mask feature's resolution."""
    B, Pc, C = cates.shape
    cell_strides = torch.tensor(np.concatenate([
        np.full(s * s, st, np.float32)
        for s, st in zip(num_grids, strides)]), device=cates.device)

    flat = torch.where(cates > score_thr, cates,
                       torch.zeros_like(cates)).reshape(B, Pc * C)
    top_scores, top_idx = top_k(flat, min(nms_pre, Pc * C))
    cell = top_idx // C
    labels = (top_idx % C).int()
    e = kernels.shape[-1]
    kernels = torch.gather(kernels, 1, cell[..., None].expand(-1, -1, e))
    mask_scores = torch.sigmoid(decode_masks(mask_feat, kernels))
    seg_masks = (mask_scores > mask_thr).float()
    sum_masks = seg_masks.sum(dim=(2, 3))
    keep = (sum_masks > cell_strides[cell]) & (top_scores > 0)
    seg_score = (mask_scores * seg_masks).sum(dim=(2, 3)) \
        / sum_masks.clamp(min=1e-6)
    scores = torch.where(keep, top_scores * seg_score,
                         torch.zeros_like(top_scores))
    new_scores = mask_matrix_nms(seg_masks, labels, scores, keep,
                                 kernel=kernel, sigma=sigma)
    del seg_masks
    new_scores = torch.where(new_scores > filter_thr, new_scores,
                             torch.zeros_like(new_scores))
    final_scores, order = top_k(new_scores, min(max_per_img, Pc))
    final_masks = torch.gather(mask_scores, 1, order[..., None, None]
                               .expand(-1, -1, *mask_scores.shape[2:]))
    return dict(scores=final_scores, labels=torch.gather(labels, 1, order),
                masks=final_masks, valid=final_scores > 0)
