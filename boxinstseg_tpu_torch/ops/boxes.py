"""Box transforms and IoU math, counterpart of
``boxinstseg_tpu/ops/boxes.py`` (reference: mmdet/core/bbox/transforms.py,
mmdet/models/losses/iou_loss.py)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def distance2bbox(points: torch.Tensor, distance: torch.Tensor,
                  max_shape: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode (l, t, r, b) distances at ``points`` (..., 2) as (x, y) into
    xyxy boxes, clipped to ``max_shape`` (..., 2) as (h, w) when given."""
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    if max_shape is not None:
        h, w = max_shape[..., 0], max_shape[..., 1]
        zero = torch.zeros_like(h)
        x1 = torch.clamp(x1, zero, w)
        y1 = torch.clamp(y1, zero, h)
        x2 = torch.clamp(x2, zero, w)
        y2 = torch.clamp(y2, zero, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * \
        (boxes[..., 3] - boxes[..., 1]).clamp(min=0)


def bbox_overlaps(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """Pairwise IoU between (..., N, 4) and (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = bbox_area(a)[..., :, None] + bbox_area(b)[..., None, :] - inter
    return inter / union.clamp(min=eps)


def aligned_iou(a: torch.Tensor, b: torch.Tensor, mode: str = 'iou',
                eps: float = 1e-6) -> torch.Tensor:
    """Elementwise IoU / GIoU between aligned (..., 4) box tensors."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = bbox_area(a) + bbox_area(b) - inter
    iou = inter / union.clamp(min=eps)
    if mode == 'iou':
        return iou
    if mode == 'giou':
        lt_e = torch.minimum(a[..., :2], b[..., :2])
        rb_e = torch.maximum(a[..., 2:], b[..., 2:])
        wh_e = (rb_e - lt_e).clamp(min=0)
        enclose = (wh_e[..., 0] * wh_e[..., 1]).clamp(min=eps)
        return iou - (enclose - union) / enclose
    raise ValueError(mode)


def bbox_overlaps_np(a, b, eps: float = 1e-6) -> np.ndarray:
    """Numpy pairwise IoU (N, 4) x (M, 4) -> (N, M) in float64 for the
    host-side analysis tools, a copy of the JAX package's
    ``bbox_overlaps_np`` (reference:
    mmdet/core/evaluation/bbox_overlaps.py)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, eps)
