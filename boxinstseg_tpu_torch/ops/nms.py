"""Static-shape NMS ops, counterpart of ``boxinstseg_tpu/ops/nms.py``.

- ``greedy_nms``: exact class-aware hard NMS as a fixed number of
  argmax-then-kill rounds over a batch of images (replaces mmcv's CUDA
  batched_nms; reference consumer: condinst_head.py:18-83
  ``nms_with_others``). The caller pre-selects a fixed candidate count and
  gets back a fixed number of kept slots and a validity mask; no round
  reads a value on the host.
- ``mask_matrix_nms``: SOLO's soft suppression over binary masks
  (reference: mmdet/core/post_processing/matrix_nms.py:5-121) for padded
  fixed-size inputs.
- ``points_nms_2x2``: SOLO's "points NMS" on the category maps.
- ``top_k``: the k largest in ``jax.lax.top_k``'s order, ties to the
  lower index (``torch.topk`` promises no order among equal values, and
  bf16 scores tie often).

Plain tensor code: the JAX package computes these in XLA, not Pallas.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .boxes import bbox_overlaps


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last dim and their indices, in
    descending order with ties to the lower index, as ``jax.lax.top_k``:
    the same selection on every device."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor,
               labels: torch.Tensor, iou_thr: float, max_det: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy hard NMS with per-class separation, per image.

    Args:
      boxes: (B, P, 4) xyxy. scores: (B, P); a candidate with score <= 0
      is invalid. labels: (B, P) int.
    Returns:
      keep_idx (B, max_det) int64 indices into P (0 in unused slots) and
      keep_valid (B, max_det) bool. Slot n holds the n-th kept box in
      score order; ties go to the lower index (``torch.argmax``, like
      ``jnp.argmax``).
    """
    b, p = scores.shape
    suppress = (bbox_overlaps(boxes, boxes) > iou_thr) \
        & (labels[:, :, None] == labels[:, None, :])          # (B, P, P)
    suppress |= torch.eye(p, dtype=torch.bool, device=boxes.device)
    alive = torch.where(scores > 0, scores, torch.full_like(scores, -1.0))
    keep_idx = torch.zeros((b, max_det), dtype=torch.long,
                           device=boxes.device)
    keep_valid = torch.zeros((b, max_det), dtype=torch.bool,
                             device=boxes.device)
    n = torch.zeros((b, 1), dtype=torch.long, device=boxes.device)
    rows = torch.arange(b, device=boxes.device)
    for _ in range(max_det):
        best = alive.argmax(dim=1)                               # (B,)
        valid = alive[rows, best] > 0
        # a kept box fills slot n of its image; an image with nothing left
        # writes (0, False) over slot n, which is still empty
        keep_idx.scatter_(1, n, torch.where(valid, best, 0)[:, None])
        keep_valid.scatter_(1, n, valid[:, None])
        kill = suppress[rows, best] & valid[:, None]
        alive = alive.masked_fill(kill, -1.0)
        n = n + valid[:, None].long()
    return keep_idx, keep_valid


def mask_matrix_nms(masks: torch.Tensor, labels: torch.Tensor,
                    scores: torch.Tensor, valid: torch.Tensor,
                    kernel: str = 'gaussian', sigma: float = 2.0
                    ) -> torch.Tensor:
    """Matrix NMS over binary masks, per image; returns decayed scores.

    Args:
      masks: (B, N, H, W) binary float masks, padded rows allowed.
      labels: (B, N). scores: (B, N), in any order. valid: (B, N) bool.
    Returns:
      (B, N) decayed scores in the input's row order; invalid rows get 0.
    """
    b, n = scores.shape
    scores = torch.where(valid, scores, torch.zeros_like(scores))
    # a stable descending sort, as jnp.argsort(-scores)
    order = torch.argsort(-scores, dim=1, stable=True)
    rank = torch.argsort(order, dim=1)

    # the products in the input's order, then rows and columns permuted:
    # no sorted copy of the (B, N, H*W) masks
    flat = masks.reshape(b, n, -1)
    areas = torch.gather(flat.sum(dim=2), 1, order)
    inter = torch.bmm(flat, flat.transpose(1, 2))
    inter = torch.gather(inter, 1, order[:, :, None].expand(-1, -1, n))
    inter = torch.gather(inter, 2, order[:, None, :].expand(-1, n, -1))
    union = areas[:, :, None] + areas[:, None, :] - inter
    iou = inter / union.clamp(min=1e-6)

    labels_s = torch.gather(labels, 1, order)
    valid_s = torch.gather(valid, 1, order)
    same = (labels_s[:, :, None] == labels_s[:, None, :]) \
        & valid_s[:, :, None] & valid_s[:, None, :]
    # upper triangle: j is suppressed by i when i ranks above j
    tri = torch.ones((n, n), dtype=torch.bool, device=masks.device).triu(1)
    iou_m = torch.where(same & tri, iou, torch.zeros_like(iou))

    # IoU compensation: the largest IoU each suppressor i suffered from a
    # higher-ranked mask of its class, along i's row
    comp = iou_m.amax(dim=1)[:, :, None]
    if kernel == 'gaussian':
        decay = torch.exp(-sigma * (iou_m ** 2 - comp ** 2))
    elif kernel == 'linear':
        decay = (1.0 - iou_m) / (1.0 - comp).clamp(min=1e-6)
    else:
        raise ValueError(kernel)
    decay_factor = decay.amin(dim=1)                 # per suppressee

    new_sorted = torch.gather(scores, 1, order) * decay_factor
    new = torch.gather(new_sorted, 1, rank)
    return torch.where(valid, new, torch.zeros_like(new))


def points_nms_2x2(heat: torch.Tensor) -> torch.Tensor:
    """Keep a score only where it is the max of its 2x2 neighbourhood
    reaching up and left (reference: box_solov2_head.py points_nms, a 2x2
    max pool with padding 1). heat: (..., H, W)."""
    hp = F.pad(heat, (1, 0, 1, 0), value=float('-inf'))
    m = torch.maximum(torch.maximum(hp[..., :-1, :-1], hp[..., :-1, 1:]),
                      torch.maximum(hp[..., 1:, :-1], hp[..., 1:, 1:]))
    return torch.where(heat >= m, heat, torch.zeros_like(heat))
