"""Host-side (numpy/cv2) data pipeline transforms.

Behavior-parity rebuild of the reference pipeline stages the shipped
configs use (reference: mmdet/datasets/pipelines/{loading,transforms,
formatting}.py): LoadImageFromFile, LoadAnnotations, Resize (multiscale
'value'/'range' keep_ratio), RandomFlip, Normalize, Pad, RandomCrop,
GenerateBoxMask, FilterAnnotations, DefaultFormatBundle/Collect.

Each transform is a callable on a ``results`` dict. Output arrays are
numpy; the static-shape batcher (batcher.py) turns them into fixed-canvas
device batches.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..registry import PIPELINES
from ..core.structures import BitmapMasks, PolygonMasks


def _imread(path: str, to_rgb: bool = True) -> np.ndarray:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img  # BGR uint8 (converted later by Normalize's to_rgb)


def _imrescale_size(h, w, scale: Tuple[int, int]) -> Tuple[int, int]:
    """mmcv rescale: fit (h, w) into scale keeping aspect ratio."""
    max_long, max_short = max(scale), min(scale)
    ratio = min(max_long / max(h, w), max_short / min(h, w))
    return int(w * ratio + 0.5), int(h * ratio + 0.5)  # (new_w, new_h)


@PIPELINES.register_module()
class LoadImageFromFile:
    def __init__(self, to_float32: bool = False, color_type: str = 'color',
                 file_client_args: Optional[dict] = None):
        self.to_float32 = to_float32

    def __call__(self, results: Dict) -> Dict:
        if 'img' not in results:
            path = results.get('filename')
            if path is None:
                info = results['img_info']
                path = os.path.join(results.get('img_prefix', ''),
                                    info['file_name'])
                results['filename'] = path
            img = _imread(path)
            results['img'] = img
        img = results['img']
        if self.to_float32:
            img = img.astype(np.float32)
            results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        results['img_fields'] = ['img']
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    def __init__(self, with_bbox: bool = True, with_label: bool = True,
                 with_mask: bool = False, with_seg: bool = False,
                 poly2mask: bool = True, file_client_args=None):
        self.with_bbox = with_bbox
        self.with_label = with_label
        self.with_mask = with_mask
        self.poly2mask = poly2mask

    def __call__(self, results: Dict) -> Dict:
        ann = results['ann_info']
        if self.with_bbox:
            results['gt_bboxes'] = ann['bboxes'].astype(np.float32).copy()
            results.setdefault('bbox_fields', []).append('gt_bboxes')
        if self.with_label:
            results['gt_labels'] = ann['labels'].astype(np.int64).copy()
        if self.with_mask:
            h, w = results['img'].shape[:2]
            segs = ann.get('segmentations') or []
            if segs and not self.poly2mask \
                    and all(isinstance(sg, (list, tuple)) for sg in segs):
                masks = PolygonMasks(list(segs), h, w).to_bitmap()
            else:
                from .coco_api import poly_to_mask, rle_decode
                arr = []
                for sg in segs:
                    if isinstance(sg, dict):
                        arr.append(rle_decode(sg))
                    elif sg is None:
                        arr.append(np.zeros((h, w), np.uint8))
                    else:
                        arr.append(poly_to_mask(sg, h, w))
                masks = BitmapMasks(arr, h, w)
            results['gt_masks'] = masks
            results.setdefault('mask_fields', []).append('gt_masks')
        return results


@PIPELINES.register_module()
class Resize:
    """keep_ratio rescale with multiscale 'value' (pick one of img_scale) or
    'range' modes (reference transforms.py Resize)."""

    def __init__(self, img_scale=None, multiscale_mode: str = 'range',
                 ratio_range=None, keep_ratio: bool = True,
                 bbox_clip_border: bool = True, override: bool = False,
                 backend: str = 'cv2'):
        if img_scale is None:
            self.img_scales = None
        elif isinstance(img_scale, tuple):
            self.img_scales = [img_scale]
        else:
            self.img_scales = [tuple(s) for s in img_scale]
        self.multiscale_mode = multiscale_mode
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio
        self.bbox_clip_border = bbox_clip_border

    def _pick_scale(self, rng: np.random.RandomState):
        if self.ratio_range is not None:
            base = self.img_scales[0]
            r = rng.uniform(*self.ratio_range)
            return (int(base[0] * r), int(base[1] * r))
        if len(self.img_scales) == 1:
            return self.img_scales[0]
        if self.multiscale_mode == 'value':
            return self.img_scales[rng.randint(len(self.img_scales))]
        # 'range'
        longs = [max(s) for s in self.img_scales]
        shorts = [min(s) for s in self.img_scales]
        l = rng.randint(min(longs), max(longs) + 1)
        s = rng.randint(min(shorts), max(shorts) + 1)
        return (l, s)

    def __call__(self, results: Dict) -> Dict:
        import cv2
        rng = results.get('rng') or np.random
        scale = (results.pop('batch_scale', None)
                 or results.get('scale') or self._pick_scale(rng))
        img = results['img']
        h, w = img.shape[:2]
        if self.keep_ratio:
            new_w, new_h = _imrescale_size(h, w, scale)
        else:
            new_w, new_h = scale[1], scale[0]
        resized = cv2.resize(img, (new_w, new_h),
                             interpolation=cv2.INTER_LINEAR)
        w_scale = new_w / w
        h_scale = new_h / h
        results['img'] = resized
        results['img_shape'] = resized.shape
        results['pad_shape'] = resized.shape
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        results['keep_ratio'] = self.keep_ratio

        for key in results.get('bbox_fields', []):
            boxes = results[key] * results['scale_factor']
            if self.bbox_clip_border:
                boxes[:, 0::2] = boxes[:, 0::2].clip(0, new_w)
                boxes[:, 1::2] = boxes[:, 1::2].clip(0, new_h)
            results[key] = boxes
        for key in results.get('mask_fields', []):
            results[key] = results[key].resize((new_h, new_w))
        return results


@PIPELINES.register_module()
class RandomFlip:
    def __init__(self, flip_ratio: Optional[float] = None,
                 direction: str = 'horizontal'):
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, results: Dict) -> Dict:
        rng = results.get('rng') or np.random
        flip = (self.flip_ratio is not None
                and rng.rand() < self.flip_ratio)
        results['flip'] = bool(results.get('flip', flip))
        results['flip_direction'] = self.direction
        if not results['flip']:
            return results
        img = results['img']
        h, w = img.shape[:2]
        results['img'] = img[:, ::-1].copy()
        for key in results.get('bbox_fields', []):
            boxes = results[key].copy()
            boxes[:, 0] = w - results[key][:, 2]
            boxes[:, 2] = w - results[key][:, 0]
            results[key] = boxes
        for key in results.get('mask_fields', []):
            results[key] = results[key].flip(self.direction)
        return results


@PIPELINES.register_module()
class Normalize:
    def __init__(self, mean, std, to_rgb: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results: Dict) -> Dict:
        img = results['img'].astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        img = (img - self.mean) / self.std
        results['img'] = img
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class Pad:
    def __init__(self, size=None, size_divisor: Optional[int] = None,
                 pad_val: float = 0.0, pad_to_square: bool = False):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th = ((h + d - 1) // d) * d
            tw = ((w + d - 1) // d) * d
        padded = np.full((th, tw) + img.shape[2:], self.pad_val,
                         img.dtype)
        padded[:h, :w] = img
        results['img'] = padded
        results['pad_shape'] = padded.shape
        results['pad_fixed_size'] = self.size
        results['pad_size_divisor'] = self.size_divisor
        for key in results.get('mask_fields', []):
            results[key] = results[key].pad((th, tw))
        return results


@PIPELINES.register_module()
class GenerateBoxMask:
    """Turn each GT box into a rectangular bitmask
    (reference: mmdet/datasets/pipelines/loading.py:647-666)."""

    def __call__(self, results: Dict) -> Dict:
        h, w = results['img_shape'][:2]
        masks = []
        for box in results['gt_bboxes']:
            m = np.zeros((h, w), np.uint8)
            x1, y1, x2, y2 = box
            m[int(y1):int(y2) + 1, int(x1):int(x2) + 1] = 1
            masks.append(m)
        results['gt_masks'] = BitmapMasks(masks, h, w) if masks \
            else BitmapMasks([], h, w)
        results.setdefault('mask_fields', []).append('gt_masks')
        return results


@PIPELINES.register_module()
class FilterAnnotations:
    def __init__(self, min_gt_bbox_wh=(1e-2, 1e-2), keep_empty: bool = True):
        self.min_wh = min_gt_bbox_wh
        self.keep_empty = keep_empty

    def __call__(self, results: Dict) -> Optional[Dict]:
        boxes = results['gt_bboxes']
        wh = boxes[:, 2:] - boxes[:, :2]
        keep = (wh[:, 0] > self.min_wh[0]) & (wh[:, 1] > self.min_wh[1])
        results['gt_bboxes'] = boxes[keep]
        results['gt_labels'] = results['gt_labels'][keep]
        if 'gt_masks' in results:
            results['gt_masks'] = results['gt_masks'][keep]
        return results


@PIPELINES.register_module()
class RandomCrop:
    def __init__(self, crop_size, crop_type: str = 'absolute',
                 allow_negative_crop: bool = False,
                 recompute_bbox: bool = False, bbox_clip_border: bool = True):
        self.crop_size = crop_size
        self.crop_type = crop_type
        self.allow_negative_crop = allow_negative_crop
        self.bbox_clip_border = bbox_clip_border

    def _get_size(self, h, w, rng):
        if self.crop_type == 'absolute':
            return min(self.crop_size[0], h), min(self.crop_size[1], w)
        if self.crop_type == 'absolute_range':
            ch = rng.randint(min(self.crop_size[0], h),
                             min(self.crop_size[1], h) + 1)
            cw = rng.randint(min(self.crop_size[0], w),
                             min(self.crop_size[1], w) + 1)
            return ch, cw
        if self.crop_type == 'relative':
            return int(h * self.crop_size[0]), int(w * self.crop_size[1])
        raise ValueError(self.crop_type)

    def __call__(self, results: Dict) -> Optional[Dict]:
        rng = results.get('rng') or np.random
        img = results['img']
        h, w = img.shape[:2]
        ch, cw = self._get_size(h, w, rng)
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
        results['img'] = img[y0:y0 + ch, x0:x0 + cw].copy()
        results['img_shape'] = results['img'].shape
        if 'gt_bboxes' in results:
            boxes = results['gt_bboxes'] - np.array(
                [x0, y0, x0, y0], np.float32)
            if self.bbox_clip_border:
                boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
                boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            if not keep.any() and not self.allow_negative_crop:
                return None
            results['gt_bboxes'] = boxes[keep]
            results['gt_labels'] = results['gt_labels'][keep]
            if 'gt_masks' in results:
                results['gt_masks'] = results['gt_masks'][keep].crop(
                    (x0, y0, x0 + cw, y0 + ch))
        return results


@PIPELINES.register_module()
class DefaultFormatBundle:
    """No-op adaptor: tensors stay numpy; batching handles layout."""

    def __call__(self, results: Dict) -> Dict:
        return results


@PIPELINES.register_module()
class ImageToTensor:
    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results: Dict) -> Dict:
        return results


@PIPELINES.register_module()
class Collect:
    def __init__(self, keys, meta_keys=None):
        self.keys = list(keys)

    def __call__(self, results: Dict) -> Dict:
        results['_collect_keys'] = self.keys
        return results


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """Test-time wrapper; single-scale no-flip path (the only mode the
    shipped configs use)."""

    def __init__(self, transforms, img_scale, flip: bool = False,
                 flip_direction='horizontal'):
        self.transforms = Compose(transforms)
        self.img_scale = img_scale if isinstance(img_scale, tuple) \
            else tuple(img_scale)
        self.flip = flip

    def __call__(self, results: Dict) -> Dict:
        results['scale'] = self.img_scale
        results['flip'] = False
        return self.transforms(results)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = []
        for t in transforms:
            if callable(t):
                self.transforms.append(t)
            else:
                self.transforms.append(PIPELINES.build(t))

    def __call__(self, results: Dict) -> Optional[Dict]:
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results
