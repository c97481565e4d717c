"""Mask containers and per-instance data (reference:
mmdet/core/mask/structures.py BitmapMasks/PolygonMasks — 1102 LoC — and
mmdet/core/data_structures/instance_data.py InstanceData).

The TPU pipeline carries padded dense arrays, so these are thin numpy
containers for the host-side boundary (pipeline <-> batcher <-> eval),
with the subset of operations the toolbox exercises.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


class BitmapMasks:
    """A stack of binary masks (N, H, W) uint8."""

    def __init__(self, masks, height: int, width: int):
        self.height = height
        self.width = width
        if len(masks) == 0:
            self.masks = np.zeros((0, height, width), np.uint8)
        else:
            self.masks = np.stack([np.asarray(m, np.uint8) for m in masks])

    def __len__(self):
        return len(self.masks)

    def __getitem__(self, idx):
        masks = self.masks[idx]
        if masks.ndim == 2:
            masks = masks[None]
        return BitmapMasks(masks, self.height, self.width)

    def __iter__(self):
        # like the reference container: iterate raw (H, W) arrays
        return iter(self.masks)

    @property
    def areas(self) -> np.ndarray:
        return self.masks.sum((1, 2))

    def to_ndarray(self) -> np.ndarray:
        return self.masks

    def resize(self, out_shape) -> 'BitmapMasks':
        import cv2
        h, w = out_shape
        if len(self) == 0:
            return BitmapMasks([], h, w)
        resized = [cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST)
                   for m in self.masks]
        return BitmapMasks(resized, h, w)

    def flip(self, direction: str = 'horizontal') -> 'BitmapMasks':
        axis = 2 if direction == 'horizontal' else 1
        return BitmapMasks(np.flip(self.masks, axis=axis).copy(),
                           self.height, self.width)

    def pad(self, out_shape, pad_val: int = 0) -> 'BitmapMasks':
        h, w = out_shape
        padded = np.full((len(self), h, w), pad_val, np.uint8)
        padded[:, :self.height, :self.width] = self.masks
        return BitmapMasks(padded, h, w)

    def crop(self, bbox) -> 'BitmapMasks':
        x1, y1, x2, y2 = (int(v) for v in bbox)
        cropped = self.masks[:, y1:y2, x1:x2]
        return BitmapMasks(cropped, y2 - y1, x2 - x1)

    def expand(self, expanded_h, expanded_w, top, left) -> 'BitmapMasks':
        out = np.zeros((len(self), expanded_h, expanded_w), np.uint8)
        out[:, top:top + self.height, left:left + self.width] = self.masks
        return BitmapMasks(out, expanded_h, expanded_w)


class PolygonMasks:
    """COCO polygon lists; rasterized on demand."""

    def __init__(self, masks: Sequence, height: int, width: int):
        self.masks = list(masks)
        self.height = height
        self.width = width

    def __len__(self):
        return len(self.masks)

    def __iter__(self):
        return iter(self.masks)

    def to_bitmap(self) -> BitmapMasks:
        from ..data.coco_api import poly_to_mask
        bitmaps = [poly_to_mask(polys, self.height, self.width)
                   for polys in self.masks]
        return BitmapMasks(bitmaps, self.height, self.width)

    def to_ndarray(self) -> np.ndarray:
        return self.to_bitmap().masks


class InstanceData:
    """Attribute dict of aligned per-instance arrays (reference:
    core/data_structures/instance_data.py). Supports len, indexing by
    slice/bool-array, and attribute access."""

    _META = ('img_shape', 'ori_shape', 'scale_factor', 'pad_shape')

    def __init__(self, metainfo: Dict = None, **fields):
        object.__setattr__(self, '_meta', dict(metainfo or {}))
        object.__setattr__(self, '_fields', {})
        for k, v in fields.items():
            setattr(self, k, v)

    def __setattr__(self, key, value):
        if key in ('_meta', '_fields'):
            object.__setattr__(self, key, value)
        else:
            self._fields[key] = value

    def __getattr__(self, key):
        if key in self._fields:
            return self._fields[key]
        if key in self._meta:
            return self._meta[key]
        raise AttributeError(key)

    @property
    def metainfo(self) -> Dict:
        """Meta dict (reference GeneralData.metainfo property)."""
        return self._meta

    def __len__(self):
        for v in self._fields.values():
            return len(v)
        return 0

    def __getitem__(self, idx):
        if isinstance(idx, str):      # field access, like the reference
            return self._fields[idx]
        out = InstanceData(self._meta)
        for k, v in self._fields.items():
            out._fields[k] = v[idx]
        return out

    def __contains__(self, key):
        return key in self._fields

    def keys(self):
        return self._fields.keys()

    def items(self):
        return self._fields.items()

    def __repr__(self):
        fields = {k: getattr(v, 'shape', len(v))
                  for k, v in self._fields.items()}
        return f'InstanceData(meta={list(self._meta)}, fields={fields})'
