"""RoIAlign written by hand (torchvision is not a dependency), counterpart
of ``boxinstseg_tpu/ops/roi_align.py``.

The JAX package's conventions: ``aligned=True`` (pixel-centre offset -0.5),
a fixed ``sampling_ratio`` of 2 points a bin on each axis, zeros outside
the map. The JAX package gathers from a 2x2 patch table when there are many
samples and gathers the four corners directly when there are few; both give
the same values, and so does the one form here, four direct corner gathers
from the (B, C, H, W) map with each ROI's own image index. No per-image
table is built, so the JAX package's preselect of the referenced images
(when there are fewer ROIs than images) has nothing to save here.
"""
from __future__ import annotations

import torch


def roi_align(feat: torch.Tensor, rois: torch.Tensor, out_size,
              sampling_ratio: int = 2, aligned: bool = True,
              spatial_scale: float = 1.0) -> torch.Tensor:
    """feat (B, C, H, W); rois (N, 5) of (batch index, x1, y1, x2, y2) in
    feature coordinates / spatial_scale. Returns (N, C, oh, ow)."""
    oh, ow = (out_size, out_size) if isinstance(out_size, int) else out_size
    _, c, h, w = feat.shape
    n = rois.shape[0]
    bidx = rois[:, 0].long()
    boxes = rois[:, 1:] * spatial_scale
    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] - offset
    y1 = boxes[:, 1] - offset
    roi_w = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1e-3)
    roi_h = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1e-3)
    bin_w = roi_w / ow
    bin_h = roi_h / oh
    s = sampling_ratio
    dev = feat.device
    iy = (torch.arange(oh * s, device=dev, dtype=torch.float32) + 0.5) / s
    ix = (torch.arange(ow * s, device=dev, dtype=torch.float32) + 0.5) / s
    ys = y1[:, None] + iy[None, :] * bin_h[:, None]             # (N, oh*s)
    xs = x1[:, None] + ix[None, :] * bin_w[:, None]             # (N, ow*s)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]

    def corner(yy, xx):
        inb = ((yy >= 0) & (yy < h))[:, :, None] \
            & ((xx >= 0) & (xx < w))[:, None, :]
        yi = torch.clamp(yy, 0, h - 1).long()
        xi = torch.clamp(xx, 0, w - 1).long()
        g = feat[bidx[:, None, None], :, yi[:, :, None], xi[:, None, :]]
        return g * inb[..., None].to(g.dtype)                   # (N,ohs,ows,C)

    v00 = corner(y0, x0)
    v01 = corner(y0, x0 + 1)
    v10 = corner(y0 + 1, x0)
    v11 = corner(y0 + 1, x0 + 1)
    vals = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))
    vals = vals.reshape(n, oh, s, ow, s, c).mean(dim=(2, 4))
    return vals.permute(0, 3, 1, 2)
