"""Static-shape batch assembly — the TPU-side contract of the data layer.

The reference pads each batch to the max size within the batch
(dynamic shapes, fine for CUDA). XLA compiles per shape, so here every
batch lands on one of a small set of fixed canvases (one per orientation
bucket by default), and per-image GT lists are padded to a fixed
``max_gts`` with a validity mask. This replaces DataContainer/collate
(reference: mmdet/datasets/builder.py:87-206 + mmcv collate).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class StaticBatcher:
    def __init__(self,
                 canvases: Sequence[Tuple[int, int]] = ((800, 1344),
                                                        (1344, 800)),
                 max_gts: int = 100,
                 bottom_pixels_removed: int = 10,
                 with_masks: bool = False,
                 mask_stride: int = 1,
                 gt_buckets: Optional[Sequence[int]] = None):
        self.canvases = [tuple(c) for c in canvases]
        self.max_gts = max_gts
        self.bottom_pixels_removed = bottom_pixels_removed
        self.with_masks = with_masks
        self.mask_stride = mask_stride
        # GT-capacity buckets (same idea as canvas buckets): each batch
        # pads its GT lists to the SMALLEST bucket >= the batch's live
        # max instead of always max_gts. Zero math change — every live
        # instance still fits — but the per-instance loss terms (tree
        # filter / LCM / Hungarian / levelset in Box2Mask) stop paying
        # for empty slots: COCO averages ~7 instances while max_gts is
        # 100, so the padded capacity dominated those costs 6x+. One
        # XLA compile per (canvas, bucket) pair actually seen.
        bk = sorted(int(g) for g in gt_buckets) if gt_buckets else []
        if not bk or bk[-1] < max_gts:
            bk.append(max_gts)
        self.gt_buckets = bk

    def pick_canvas(self, h: int, w: int) -> Tuple[int, int]:
        """Smallest canvas that fits (h, w); prefers same orientation."""
        fits = [c for c in self.canvases if c[0] >= h and c[1] >= w]
        if not fits:
            raise ValueError(
                f'image {h}x{w} does not fit any canvas {self.canvases}')
        return min(fits, key=lambda c: c[0] * c[1])

    def _n_live(self, smp) -> int:
        bx = smp.get('gt_bboxes')
        return 0 if bx is None else min(len(bx), self.max_gts)

    def extent(self, samples: List[Dict]) -> Tuple[int, int, int]:
        """(largest height, largest width, most live GTs) of ``samples``:
        what picks the canvas and the GT capacity of their batch."""
        return (max(s['img'].shape[0] for s in samples),
                max(s['img'].shape[1] for s in samples),
                max((self._n_live(s) for s in samples), default=0))

    def __call__(self, samples: List[Dict],
                 extent: Optional[Sequence[int]] = None
                 ) -> Dict[str, np.ndarray]:
        """samples: list of pipeline result dicts. All must share one
        canvas (use the aspect-ratio group sampler). ``extent`` (default
        ``self.extent(samples)``) picks the canvas and the GT capacity: a
        process that holds a slice of a global batch passes the global
        batch's, so that it pads as the whole batch would."""
        b = len(samples)
        max_h, max_w, live = (self.extent(samples) if extent is None
                              else (int(v) for v in extent))
        ch, cw = self.pick_canvas(max_h, max_w)

        images = np.zeros((b, ch, cw, 3), np.float32)
        img_shape = np.zeros((b, 2), np.int32)
        ori_shape = np.zeros((b, 2), np.int32)
        scale_factor = np.ones((b, 4), np.float32)
        pixels_removed = np.zeros((b,), np.int32)
        cap = next((g for g in self.gt_buckets if g >= live),
                   self.max_gts)
        gt_bboxes = np.zeros((b, cap, 4), np.float32)
        gt_labels = np.zeros((b, cap), np.int32)
        gt_valid = np.zeros((b, cap), bool)
        gt_masks = None
        if self.with_masks:
            s = self.mask_stride
            gt_masks = np.zeros((b, cap, ch // s, cw // s),
                                np.uint8)

        for i, smp in enumerate(samples):
            img = smp['img']
            h, w = img.shape[:2]
            images[i, :h, :w] = img
            img_shape[i] = (h, w)
            oh, ow = smp['ori_shape'][:2]
            ori_shape[i] = (oh, ow)
            scale_factor[i] = smp.get('scale_factor', np.ones(4, np.float32))
            pixels_removed[i] = int(
                self.bottom_pixels_removed * float(h) / float(oh))
            boxes = smp.get('gt_bboxes')
            if boxes is not None and len(boxes):
                n = min(len(boxes), self.max_gts)
                gt_bboxes[i, :n] = boxes[:n]
                gt_labels[i, :n] = smp['gt_labels'][:n]
                gt_valid[i, :n] = True
                if gt_masks is not None and 'gt_masks' in smp:
                    s = self.mask_stride
                    # BitmapMasks container (pipeline) or raw (N, H, W)
                    marr = getattr(smp['gt_masks'], 'masks',
                                   smp['gt_masks'])
                    for g in range(n):
                        m = np.asarray(marr[g])
                        mh, mw = m.shape[:2]
                        gt_masks[i, g, :math.ceil(mh / s),
                                 :math.ceil(mw / s)] = m[::s, ::s]

        batch = dict(image=images, img_shape=img_shape, ori_shape=ori_shape,
                     scale_factor=scale_factor,
                     pixels_removed=pixels_removed,
                     gt_bboxes=gt_bboxes, gt_labels=gt_labels,
                     gt_valid=gt_valid)
        if gt_masks is not None:
            batch['gt_masks'] = gt_masks
        return batch
