"""Multi-level point (prior) generation for FCOS-style heads
(reference: mmdet MlvlPointGenerator with offset=0.5), counterpart of
``boxinstseg_tpu/ops/points.py``."""
from __future__ import annotations

import numpy as np
import torch


def level_points(h: int, w: int, stride: int, offset: float = 0.5
                 ) -> np.ndarray:
    """(h*w, 2) of (x, y) pixel centres for one level, row-major."""
    xs = (np.arange(w, dtype=np.float32) + offset) * stride
    ys = (np.arange(h, dtype=np.float32) + offset) * stride
    xx, yy = np.meshgrid(xs, ys)
    return np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1)


def concat_points_and_meta(featmap_sizes, strides, regress_ranges=None,
                           offset: float = 0.5, device=None):
    """Concatenate all levels' points and per-point metadata as tensors on
    ``device``.

    Returns dict with:
      points: (P, 2); strides: (P,); level_inds: (P,) int64;
      regress_ranges: (P, 2) if given.
    """
    pts, stride_arr, lvl_arr, rr_arr = [], [], [], []
    for i, ((h, w), s) in enumerate(zip(featmap_sizes, strides)):
        p = level_points(h, w, s, offset)
        pts.append(p)
        stride_arr.append(np.full((p.shape[0],), s, np.float32))
        lvl_arr.append(np.full((p.shape[0],), i, np.int64))
        if regress_ranges is not None:
            rr = np.asarray(regress_ranges[i], np.float32)
            rr_arr.append(np.broadcast_to(rr, (p.shape[0], 2)))
    out = {
        'points': np.concatenate(pts, 0),
        'strides': np.concatenate(stride_arr, 0),
        'level_inds': np.concatenate(lvl_arr, 0),
    }
    if regress_ranges is not None:
        out['regress_ranges'] = np.concatenate(rr_arr, 0)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in out.items()}
