"""CenterNet / CornerNet gaussian heatmap utilities, counterpart of
``boxinstseg_tpu/models/utils/gaussian_target.py`` (reference:
mmdet/models/utils/gaussian_target.py — gaussian2D :8-29,
gen_gaussian_target :32-65, gaussian_radius :68-155, get_local_maximum
:190-204, get_topk_from_heatmap :207-231, gather_feat :234-252,
transpose_and_gather_feat :255-268).

As in the JAX package, a gaussian is splatted by a whole-map masked
maximum, so centres and radii may be tensors; heatmaps are (B, C, H, W).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops.nms import top_k


def gaussian2D(radius: int, sigma: float = 1.0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """(2r+1, 2r+1) gaussian kernel with the tiny values zeroed (reference
    :8-29)."""
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)[None]
    y = torch.arange(-radius, radius + 1, dtype=dtype, device=device)[:, None]
    h = torch.exp(-(x * x + y * y) / (2 * sigma * sigma))
    return torch.where(h < torch.finfo(h.dtype).eps * h.max(),
                       torch.zeros_like(h), h)


def gen_gaussian_target(heatmap: torch.Tensor, center, radius,
                        k: float = 1.0) -> torch.Tensor:
    """Max-splat one gaussian of ``radius`` at ``center`` (x, y) onto an
    (H, W) heatmap (reference :32-65); the parts off the map are clipped
    as the reference's window arithmetic clips them."""
    height, width = heatmap.shape
    x, y = center
    diameter = 2 * radius + 1
    sigma = diameter / 6.0
    xs = torch.arange(width, dtype=heatmap.dtype, device=heatmap.device)
    ys = torch.arange(height, dtype=heatmap.dtype, device=heatmap.device)
    dx = xs[None, :] - x
    dy = ys[:, None] - y
    g = torch.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma))
    # gaussian2D zeroes the sub-eps values against its max (1)
    g = torch.where(g < torch.finfo(heatmap.dtype).eps, torch.zeros_like(g),
                    g)
    window = (torch.abs(dx) <= radius) & (torch.abs(dy) <= radius)
    return torch.where(window, torch.maximum(heatmap, g * k), heatmap)


def _sqrt_f32(v):
    """jnp.sqrt of a Python number or a tensor: float32."""
    return torch.sqrt(torch.as_tensor(v, dtype=torch.float32))


def gaussian_radius(det_size, min_overlap: float):
    """The least gaussian radius that keeps IoU >= min_overlap for an
    (h, w) box under CornerNet's three corner-shift cases (reference
    :68-187), in float32 as the JAX function: Python numbers enter the
    square roots from float64, tensors stay float32."""
    height, width = det_size
    a1 = 1.0
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - _sqrt_f32(b1 ** 2 - 4 * a1 * c1)) / (2 * a1)
    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 - _sqrt_f32(b2 ** 2 - 4 * a2 * c2)) / (2 * a2)
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + _sqrt_f32(b3 ** 2 - 4 * a3 * c3)) / (2 * a3)
    return torch.minimum(r1, torch.minimum(r2, r3))


def get_local_maximum(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only the local-maximum pixels of a (B, C, H, W) heatmap
    (reference :190-204)."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat, kernel, stride=1, padding=pad)
    return heat * (hmax == heat).to(heat.dtype)


def get_topk_from_heatmap(scores: torch.Tensor, k: int = 20
                          ) -> Tuple[torch.Tensor, ...]:
    """Top-k over a (B, C, H, W) heatmap -> (scores, inds, clses, ys, xs),
    inds flat over H x W (reference :207-231); ties to the lower index, as
    ``jax.lax.top_k``."""
    batch, _, height, width = scores.shape
    topk_scores, topk_inds = top_k(scores.reshape(batch, -1), k)
    topk_clses = topk_inds // (height * width)
    topk_inds = topk_inds % (height * width)
    topk_ys = topk_inds // width
    topk_xs = (topk_inds % width).to(scores.dtype)
    return (topk_scores, topk_inds, topk_clses,
            topk_ys.to(scores.dtype), topk_xs)


def gather_feat(feat: torch.Tensor, ind: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather (B, N, C) rows by (B, K) indices (reference :234-252); with
    ``mask`` the rows are zeroed instead of compacted."""
    out = torch.gather(feat, 1, ind.long()[..., None].expand(
        -1, -1, feat.shape[-1]))
    if mask is not None:
        out = torch.where(mask[..., None], out, torch.zeros_like(out))
    return out


def transpose_and_gather_feat(feat: torch.Tensor, ind: torch.Tensor
                              ) -> torch.Tensor:
    """(B, C, H, W) and flat (B, K) spatial indices -> (B, K, C)
    (reference :255-268)."""
    b, c = feat.shape[0], feat.shape[1]
    return gather_feat(feat.reshape(b, c, -1).transpose(1, 2), ind)
