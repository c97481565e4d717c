"""Test-time-augmentation merging, counterpart of
``boxinstseg_tpu/ops/merge_augs.py`` (reference:
mmdet/core/post_processing/merge_augs.py :13-160 and the box flip /
mapping helpers of mmdet/core/bbox/transforms.py :22-90).

Tensor code on the inputs' device; proposal merging goes through the
fixed-capacity ``greedy_nms``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .nms import greedy_nms


def bbox_flip(bboxes: torch.Tensor, img_shape,
              direction: str = 'horizontal') -> torch.Tensor:
    """Flip (..., 4k) xyxy boxes inside ``img_shape`` (h, w) (reference
    transforms.py:22-49)."""
    assert bboxes.shape[-1] % 4 == 0
    h, w = img_shape[0], img_shape[1]
    x1, y1, x2, y2 = (bboxes[..., 0::4], bboxes[..., 1::4],
                      bboxes[..., 2::4], bboxes[..., 3::4])
    if direction in ('horizontal', 'diagonal'):
        x1, x2 = w - x2, w - x1
    if direction in ('vertical', 'diagonal'):
        y1, y2 = h - y2, h - y1
    if direction not in ('horizontal', 'vertical', 'diagonal'):
        raise ValueError(direction)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(bboxes.shape)


def _scale(scale_factor, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(scale_factor), dtype=like.dtype,
                           device=like.device)


def bbox_mapping(bboxes, img_shape, scale_factor, flip,
                 flip_direction='horizontal'):
    """The original scale -> the testing scale (reference
    transforms.py:51-60)."""
    out = bboxes * _scale(scale_factor, bboxes)
    return bbox_flip(out, img_shape, flip_direction) if flip else out


def bbox_mapping_back(bboxes, img_shape, scale_factor, flip,
                      flip_direction='horizontal'):
    """The testing scale -> the original scale (reference
    transforms.py:63-90)."""
    out = bbox_flip(bboxes, img_shape, flip_direction) if flip else bboxes
    return out / _scale(scale_factor, bboxes)


def _meta(meta):
    return meta[0] if isinstance(meta, (list, tuple)) else meta


def merge_aug_proposals(aug_proposals: Sequence[torch.Tensor],
                        img_metas: Sequence[dict], cfg: dict
                        ) -> torch.Tensor:
    """NMS-merge augmented (n, 5) proposals mapped back to the original
    scale (reference merge_augs.py:13-84): a (max_num, 5) tensor, zero in
    the empty slots."""
    recovered = []
    for props, meta in zip(aug_proposals, img_metas):
        boxes = bbox_mapping_back(props[:, :4], meta['img_shape'],
                                  meta['scale_factor'], meta['flip'],
                                  meta.get('flip_direction', 'horizontal'))
        recovered.append(torch.cat([boxes, props[:, 4:5]], dim=1))
    allp = torch.cat(recovered, dim=0)
    nms_cfg = cfg.get('nms', dict(iou_threshold=cfg.get('nms_thr', 0.7)))
    max_num = int(cfg.get('max_per_img', cfg.get('max_num',
                                                 allp.shape[0])))
    keep, valid = greedy_nms(
        allp[None, :, :4], allp[None, :, 4],
        torch.zeros((1, allp.shape[0]), dtype=torch.long,
                    device=allp.device),
        float(nms_cfg['iou_threshold']), min(max_num, allp.shape[0]))
    out = allp[keep[0]]
    return torch.where(valid[0][:, None], out, torch.zeros_like(out))


def merge_aug_bboxes(aug_bboxes, aug_scores, img_metas, test_cfg=None):
    """The mean of the augmented detections mapped back (reference
    merge_augs.py:87-115)."""
    recovered = []
    for bboxes, meta in zip(aug_bboxes, img_metas):
        info = _meta(meta)
        recovered.append(bbox_mapping_back(
            bboxes, info['img_shape'], info['scale_factor'], info['flip'],
            info.get('flip_direction', 'horizontal')))
    bboxes = torch.stack(recovered).mean(dim=0)
    if aug_scores is None:
        return bboxes
    return bboxes, torch.stack(list(aug_scores)).mean(dim=0)


def merge_aug_scores(aug_scores):
    """reference merge_augs.py:118-123."""
    if isinstance(aug_scores[0], torch.Tensor):
        return torch.stack(list(aug_scores)).mean(dim=0)
    return np.mean(aug_scores, axis=0)


def merge_aug_masks(aug_masks, img_metas, test_cfg=None,
                    weights: Optional[Sequence[float]] = None):
    """Unflip, then average (weighted) augmented (n, c, h, w) mask logits
    (reference merge_augs.py:126-160). The sum runs in place over one
    accumulator, so the memory is the inputs and one output."""
    out: Optional[torch.Tensor] = None
    for i, (mask, meta) in enumerate(zip(aug_masks, img_metas)):
        info = _meta(meta)
        if info['flip']:
            d = info.get('flip_direction', 'horizontal')
            dims = {'horizontal': [-1], 'vertical': [-2],
                    'diagonal': [-2, -1]}.get(d)
            if dims is None:
                raise ValueError(d)
            mask = torch.flip(mask, dims)
        term = mask if weights is None else mask * float(weights[i])
        out = term.clone() if out is None else out.add_(term)
    if weights is None:
        return out / len(aug_masks)
    return out / float(np.asarray(weights, np.float32).sum())
