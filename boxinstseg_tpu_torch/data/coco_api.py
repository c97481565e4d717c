"""Self-contained COCO annotation API (no pycocotools dependency).

Provides the subset of the pycocotools COCO interface the toolbox needs
(reference consumers: mmdet/datasets/coco.py:23+): index images/annotations/
categories, decode polygon & RLE segmentations to binary masks (cv2-based
rasterization), and RLE-encode masks for result files.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np


class COCO:
    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[dict] = None):
        if annotation_file is not None:
            with open(annotation_file, 'r') as f:
                dataset = json.load(f)
        self.dataset = dataset or {}
        self._index()

    def _index(self):
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns = defaultdict(list)
        self.cat_img_map = defaultdict(list)
        for img in self.dataset.get('images', []):
            self.imgs[img['id']] = img
        for ann in self.dataset.get('annotations', []):
            self.anns[ann['id']] = ann
            self.img_to_anns[ann['image_id']].append(ann)
            self.cat_img_map[ann['category_id']].append(ann['image_id'])
        for cat in self.dataset.get('categories', []):
            self.cats[cat['id']] = cat

    # pycocotools-compatible surface -----------------------------------------
    def get_cat_ids(self, cat_names=None):
        if not cat_names:
            return sorted(self.cats.keys())
        name_to_id = {c['name']: cid for cid, c in self.cats.items()}
        return [name_to_id[n] for n in cat_names if n in name_to_id]

    getCatIds = get_cat_ids

    def get_img_ids(self, cat_ids=None):
        if not cat_ids:
            return sorted(self.imgs.keys())
        ids = set(self.imgs.keys())
        out = set()
        for c in cat_ids:
            out |= set(self.cat_img_map[c])
        return sorted(ids & out)

    getImgIds = get_img_ids

    def get_ann_ids(self, img_ids=None, cat_ids=None):
        if img_ids:
            anns = [a for i in img_ids for a in self.img_to_anns[i]]
        else:
            anns = list(self.anns.values())
        if cat_ids:
            cat_ids = set(cat_ids)
            anns = [a for a in anns if a['category_id'] in cat_ids]
        return [a['id'] for a in anns]

    getAnnIds = get_ann_ids

    def load_anns(self, ids):
        return [self.anns[i] for i in ids]

    loadAnns = load_anns

    def load_imgs(self, ids):
        return [self.imgs[i] for i in ids]

    loadImgs = load_imgs

    def load_cats(self, ids):
        return [self.cats[i] for i in ids]

    loadCats = load_cats


# ---- mask utilities (pycocotools.mask equivalents) --------------------------

def poly_to_mask(polygons: List[List[float]], h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygon lists to a binary (h, w) uint8 mask."""
    import cv2
    mask = np.zeros((h, w), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2) for p in polygons
           if len(p) >= 6]
    if pts:
        # pycocotools uses integer rounding of polygon vertices
        pts = [np.round(p).astype(np.int32) for p in pts]
        cv2.fillPoly(mask, pts, 1)
    return mask


def rle_decode(rle: dict) -> np.ndarray:
    """Decode uncompressed or compressed-string COCO RLE to (h, w) uint8.

    Uses the native C++ codec (boxinstseg_tpu/native/rle.cpp, the
    pycocotools maskApi counterpart) when available; numpy/python
    fallback otherwise."""
    import ctypes
    from ..native import rle_lib
    h, w = rle['size']
    counts = rle['counts']
    lib = rle_lib()
    if lib is not None:
        if isinstance(counts, (bytes, str)):
            s = counts if isinstance(counts, bytes) else counts.encode()
            buf = np.empty(len(s) + 4, np.uint32)
            n = lib.rle_string_decode(
                s, len(s), buf.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint32)), buf.size)
            assert n >= 0
            counts_arr = buf[:n]
        else:
            counts_arr = np.asarray(counts, np.uint32)
        out = np.empty((h, w), np.uint8)
        lib.rle_decode_counts(
            np.ascontiguousarray(counts_arr).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint32)),
            len(counts_arr), h, w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out
    if isinstance(counts, (bytes, str)):
        counts = _decode_rle_string(
            counts if isinstance(counts, bytes) else counts.encode())
    mask = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            mask[pos:pos + c] = 1
        pos += c
        val ^= 1
    return mask.reshape(w, h).T  # COCO RLE is column-major


def rle_encode(mask: np.ndarray) -> dict:
    """Encode a binary (h, w) mask to compressed COCO RLE (native C++ when
    available)."""
    import ctypes
    from ..native import rle_lib
    h, w = mask.shape
    lib = rle_lib()
    if lib is not None:
        m = np.ascontiguousarray(mask, np.uint8)
        counts = np.empty(h * w + 2, np.uint32)
        n = lib.rle_encode_mask(
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            counts.size)
        assert n >= 0
        out = ctypes.create_string_buffer(6 * n + 16)
        m_len = lib.rle_string_encode(
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n,
            out, len(out))
        assert m_len >= 0
        return {'size': [h, w], 'counts': out.raw[:m_len].decode('ascii')}
    flat = np.asfortranarray(mask).T.reshape(-1)  # column-major
    # run lengths of alternating 0/1 starting with 0s
    diffs = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    bounds = np.concatenate([[0], diffs, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    return {'size': [h, w],
            'counts': _encode_rle_string(counts).decode('ascii')}


def _encode_rle_string(counts: List[int]) -> bytes:
    """pycocotools LEB128-style RLE string encoding."""
    out = bytearray()
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1f
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _decode_rle_string(s: bytes) -> List[int]:
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1f) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def ann_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    seg = ann.get('segmentation')
    if seg is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(seg, list):
        return poly_to_mask(seg, h, w)
    return rle_decode(seg)


def mask_iou(dt: List[dict], gt: List[dict], iscrowd: List[int]
             ) -> np.ndarray:
    """IoU between RLE/binary mask dicts; crowd GT uses intersection/dt-area
    (pycocotools semantics)."""
    if not dt or not gt:
        return np.zeros((len(dt), len(gt)))
    d_masks = [rle_decode(d) if isinstance(d, dict) else d for d in dt]
    g_masks = [rle_decode(g) if isinstance(g, dict) else g for g in gt]
    d = np.stack([m.reshape(-1) for m in d_masks]).astype(np.float64)
    g = np.stack([m.reshape(-1) for m in g_masks]).astype(np.float64)
    inter = d @ g.T
    da = d.sum(1)[:, None]
    ga = g.sum(1)[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: List[int]
                  ) -> np.ndarray:
    """IoU between xywh boxes with crowd semantics."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dt = np.asarray(dt, np.float64)
    gt = np.asarray(gt, np.float64)
    x1 = np.maximum(dt[:, None, 0], gt[None, :, 0])
    y1 = np.maximum(dt[:, None, 1], gt[None, :, 1])
    x2 = np.minimum(dt[:, None, 0] + dt[:, None, 2],
                    gt[None, :, 0] + gt[None, :, 2])
    y2 = np.minimum(dt[:, None, 1] + dt[:, None, 3],
                    gt[None, :, 1] + gt[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)
