"""PointRend-style uncertainty point sampling, counterpart of
``boxinstseg_tpu/models/utils/point_sample.py`` (reference:
mmdet/models/utils/point_sample.py — get_uncertainty :6-29,
get_uncertain_point_coords_with_randomness :32-105; mmcv point_sample).

Fixed shapes: the most uncertain points are a top-k and a gather. Masks
are (N, C, H, W). The random draws are split from the selection: the
sampler takes its uniforms as ``noise``, or draws them from ``generator``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...ops.nms import top_k


def point_sample(inputs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """mmcv point_sample: bilinear samples of (N, C, H, W) at (N, P, 2)
    [0, 1] (x, y) points, grid_sample's align_corners=False with zero
    padding. Returns (N, C, P)."""
    n, c, h, w = inputs.shape
    x = points[..., 0] * w - 0.5
    y = points[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]
    flat = inputs.reshape(n, c, h * w)

    def corner(yy, xx):
        inb = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        v = torch.gather(flat, 2, idx[:, None, :].expand(n, c, -1))
        return v * inb[:, None].to(v.dtype)

    return ((1 - wy) * ((1 - wx) * corner(y0, x0) + wx * corner(y0, x0 + 1))
            + wy * ((1 - wx) * corner(y0 + 1, x0)
                    + wx * corner(y0 + 1, x0 + 1)))


def get_uncertainty(mask_pred: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """-|logit of the GT class| (reference :6-29). mask_pred (N, C, ...);
    labels (N,)."""
    if mask_pred.shape[1] == 1:
        gt_logits = mask_pred
    else:
        idx = labels.long().clamp(0, mask_pred.shape[1] - 1)
        gt_logits = torch.gather(mask_pred, 1, idx.reshape(
            -1, 1, *([1] * (mask_pred.dim() - 2))).expand(
            -1, 1, *mask_pred.shape[2:]))
    return -torch.abs(gt_logits)


def get_uncertain_point_coords_with_randomness(
        mask_pred: torch.Tensor, labels: torch.Tensor, num_points: int,
        oversample_ratio: float, importance_sample_ratio: float,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Oversample random points, keep the most uncertain share, fill the
    rest with fresh random points (reference :32-105). ``noise``: the
    oversampled (N, S, 2) uniforms and the fresh (N, num_rand, 2) ones.
    Returns (N, num_points, 2) in [0, 1]."""
    assert oversample_ratio >= 1
    assert 0 <= importance_sample_ratio <= 1
    n = mask_pred.shape[0]
    num_sampled = int(num_points * oversample_ratio)
    num_unc = int(importance_sample_ratio * num_points)
    num_rand = num_points - num_unc
    if noise is None:
        gdev = generator.device if generator is not None \
            else mask_pred.device
        noise = [torch.rand((n, s, 2), generator=generator, device=gdev,
                            dtype=mask_pred.dtype).to(mask_pred.device)
                 for s in (num_sampled, num_rand)]
    coords = noise[0]
    unc = get_uncertainty(point_sample(mask_pred, coords), labels)[:, 0, :]
    _, idx = top_k(unc, num_unc)
    picked = torch.gather(coords, 1, idx[..., None].expand(-1, -1, 2))
    if num_rand > 0:
        picked = torch.cat([picked, noise[1]], dim=1)
    return picked
