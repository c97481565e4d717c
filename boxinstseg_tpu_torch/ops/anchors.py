"""Multi-level anchor (prior) generators, counterpart of
``boxinstseg_tpu/ops/anchors.py`` (reference:
mmdet/core/anchor/anchor_generator.py — AnchorGenerator :13-468,
SSDAnchorGenerator :471-608, LegacyAnchorGenerator :610-707,
LegacySSDAnchorGenerator :709-731, YOLOAnchorGenerator :734-866).

The base anchors are host-side numpy, as in the JAX package; the grids,
valid flags, sparse priors and the GT-dependent ``responsible_flags``
(YOLO) are float32 / bool tensors on ``device`` (the card unless the
caller asks for the CPU, as mmdet's ``grid_priors(device='cuda')``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..registry import PRIOR_GENERATORS


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


@PRIOR_GENERATORS.register_module()
class AnchorGenerator:
    """Standard 2D anchor generator (reference anchor_generator.py:13).

    Anchors are (x1, y1, x2, y2) float; per grid point there are
    len(scales) * len(ratios) base anchors, scale-major by default.
    """

    def __init__(self, strides, ratios, scales=None, base_sizes=None,
                 scale_major: bool = True, octave_base_scale=None,
                 scales_per_octave=None, centers=None,
                 center_offset: float = 0.0):
        if center_offset != 0:
            assert centers is None
        assert 0 <= center_offset <= 1
        self.strides = [_pair(s) for s in strides]
        self.base_sizes = [min(s) for s in self.strides] \
            if base_sizes is None else list(base_sizes)
        assert len(self.base_sizes) == len(self.strides)

        assert ((octave_base_scale is not None
                 and scales_per_octave is not None) ^ (scales is not None))
        if scales is not None:
            self.scales = np.asarray(scales, np.float32)
        else:
            octave_scales = np.array(
                [2 ** (i / scales_per_octave)
                 for i in range(scales_per_octave)])
            self.scales = (octave_scales * octave_base_scale
                           ).astype(np.float32)
        self.octave_base_scale = octave_base_scale
        self.scales_per_octave = scales_per_octave
        self.ratios = np.asarray(ratios, np.float32)
        self.scale_major = scale_major
        self.centers = centers
        self.center_offset = center_offset
        self.base_anchors = self.gen_base_anchors()

    @property
    def num_base_priors(self) -> List[int]:
        return [a.shape[0] for a in self.base_anchors]

    num_base_anchors = num_base_priors

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def gen_base_anchors(self) -> List[np.ndarray]:
        out = []
        for i, base_size in enumerate(self.base_sizes):
            center = self.centers[i] if self.centers is not None else None
            out.append(self.gen_single_level_base_anchors(
                base_size, self.scales, self.ratios, center))
        return out

    def gen_single_level_base_anchors(self, base_size, scales, ratios,
                                      center=None) -> np.ndarray:
        w = h = float(base_size)
        if center is None:
            x_c, y_c = self.center_offset * w, self.center_offset * h
        else:
            x_c, y_c = center
        h_ratios = np.sqrt(ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (w * w_ratios[:, None] * scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * scales[None, :]).reshape(-1)
        else:
            ws = (w * scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * scales[:, None] * h_ratios[None, :]).reshape(-1)
        return np.stack([x_c - 0.5 * ws, y_c - 0.5 * hs,
                         x_c + 0.5 * ws, y_c + 0.5 * hs],
                        axis=-1).astype(np.float32)

    def single_level_grid_priors(self, featmap_size: Tuple[int, int],
                                 level_idx: int, device='cuda'
                                 ) -> torch.Tensor:
        """(H * W * A, 4) anchors of one level, row-major cells, the
        cell's base anchors together."""
        base = torch.from_numpy(self.base_anchors[level_idx]).to(device)
        feat_h, feat_w = featmap_size
        sw, sh = self.strides[level_idx]
        shift_x = torch.arange(feat_w, dtype=torch.float32,
                               device=device) * sw
        shift_y = torch.arange(feat_h, dtype=torch.float32,
                               device=device) * sh
        xx = shift_x.repeat(feat_h)
        yy = shift_y.repeat_interleave(feat_w)
        shifts = torch.stack([xx, yy, xx, yy], dim=-1)
        return (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)

    def grid_priors(self, featmap_sizes: Sequence[Tuple[int, int]],
                    device='cuda') -> List[torch.Tensor]:
        assert self.num_levels == len(featmap_sizes)
        return [self.single_level_grid_priors(fs, i, device)
                for i, fs in enumerate(featmap_sizes)]

    # mmdet v2 alias
    grid_anchors = grid_priors

    def sparse_priors(self, prior_idxs: torch.Tensor,
                      featmap_size: Tuple[int, int],
                      level_idx: int) -> torch.Tensor:
        """Anchors for flat prior indices (reference :289-330), on the
        indices' device."""
        h, w = featmap_size
        prior_idxs = prior_idxs.long()
        num_base = self.num_base_priors[level_idx]
        base_id = prior_idxs % num_base
        xs = ((prior_idxs // num_base) % w) * self.strides[level_idx][0]
        ys = ((prior_idxs // (num_base * w)) % h) * \
            self.strides[level_idx][1]
        shift = torch.stack([xs, ys, xs, ys], dim=-1).to(torch.float32)
        base = torch.from_numpy(self.base_anchors[level_idx]).to(
            prior_idxs.device)
        return base[base_id] + shift

    def valid_flags(self, featmap_sizes, pad_shape, device='cuda'
                    ) -> List[torch.Tensor]:
        """Anchors whose grid cell lies inside the (unpadded) image
        (reference :392-421)."""
        out = []
        for i, (feat_h, feat_w) in enumerate(featmap_sizes):
            sw, sh = self.strides[i]
            h, w = pad_shape[:2]
            vh = min(int(np.ceil(h / sh)), feat_h)
            vw = min(int(np.ceil(w / sw)), feat_w)
            vx = np.zeros(feat_w, bool)
            vy = np.zeros(feat_h, bool)
            vx[:vw] = True
            vy[:vh] = True
            valid = (np.tile(vx, feat_h) & np.repeat(vy, feat_w))
            out.append(torch.from_numpy(np.repeat(
                valid, self.num_base_priors[i])).to(device))
        return out


@PRIOR_GENERATORS.register_module()
class SSDAnchorGenerator(AnchorGenerator):
    """SSD anchors (reference anchor_generator.py:471-608): per-level
    min/max sizes (hardcoded ratio schedule for SSD300/512 when not
    given), per-level scales/ratios, the [1, s_max, ratio...] reorder."""

    def __init__(self, strides, ratios, min_sizes=None, max_sizes=None,
                 basesize_ratio_range=(0.15, 0.9), input_size=300,
                 scale_major: bool = True):
        assert len(strides) == len(ratios)
        assert (min_sizes is None) == (max_sizes is None)
        self.strides = [_pair(s) for s in strides]
        self.centers = [(s[0] / 2., s[1] / 2.) for s in self.strides]

        if min_sizes is None:
            self.input_size = input_size
            self.basesize_ratio_range = basesize_ratio_range
            min_ratio, max_ratio = basesize_ratio_range
            min_ratio, max_ratio = int(min_ratio * 100), int(max_ratio * 100)
            step = int(np.floor(max_ratio - min_ratio)
                       / (len(strides) - 2))
            min_sizes, max_sizes = [], []
            for ratio in range(min_ratio, max_ratio + 1, step):
                min_sizes.append(int(input_size * ratio / 100))
                max_sizes.append(int(input_size * (ratio + step) / 100))
            first = {
                (300, 0.15): (7, 15), (300, 0.2): (10, 20),
                (512, 0.1): (4, 10), (512, 0.15): (7, 15),
            }.get((input_size, basesize_ratio_range[0]))
            if first is None:
                raise ValueError(
                    f'unsupported SSD anchor config: input_size='
                    f'{input_size}, ratio_range={basesize_ratio_range}')
            min_sizes.insert(0, int(input_size * first[0] / 100))
            max_sizes.insert(0, int(input_size * first[1] / 100))
        assert len(min_sizes) == len(max_sizes) == len(strides)

        anchor_ratios, anchor_scales = [], []
        for k in range(len(self.strides)):
            scales = [1., float(np.sqrt(max_sizes[k] / min_sizes[k]))]
            anchor_ratio = [1.]
            for r in ratios[k]:
                anchor_ratio += [1 / r, r]
            anchor_ratios.append(np.asarray(anchor_ratio, np.float32))
            anchor_scales.append(np.asarray(scales, np.float32))
        self.base_sizes = list(min_sizes)
        self.scales = anchor_scales
        self.ratios = anchor_ratios
        self.scale_major = scale_major
        self.center_offset = 0.0
        self.base_anchors = self.gen_base_anchors()

    def gen_base_anchors(self) -> List[np.ndarray]:
        out = []
        for i, base_size in enumerate(self.base_sizes):
            base = self.gen_single_level_base_anchors(
                base_size, self.scales[i], self.ratios[i],
                self.centers[i])
            indices = list(range(len(self.ratios[i])))
            indices.insert(1, len(indices))
            out.append(base[indices])
        return out


@PRIOR_GENERATORS.register_module()
class LegacyAnchorGenerator(AnchorGenerator):
    """MMDetection V1.x anchors: (w-1)-style centers + rounding
    (reference anchor_generator.py:610-707)."""

    def gen_single_level_base_anchors(self, base_size, scales, ratios,
                                      center=None) -> np.ndarray:
        w = h = float(base_size)
        if center is None:
            x_c = self.center_offset * (w - 1)
            y_c = self.center_offset * (h - 1)
        else:
            x_c, y_c = center
        h_ratios = np.sqrt(ratios)
        w_ratios = 1.0 / h_ratios
        if self.scale_major:
            ws = (w * w_ratios[:, None] * scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * scales[None, :]).reshape(-1)
        else:
            ws = (w * scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * scales[:, None] * h_ratios[None, :]).reshape(-1)
        return np.round(np.stack(
            [x_c - 0.5 * (ws - 1), y_c - 0.5 * (hs - 1),
             x_c + 0.5 * (ws - 1), y_c + 0.5 * (hs - 1)],
            axis=-1)).astype(np.float32)


@PRIOR_GENERATORS.register_module()
class LegacySSDAnchorGenerator(SSDAnchorGenerator, LegacyAnchorGenerator):
    """V1.x SSD anchors: SSD sizes + legacy 0.5-shifted centers
    (reference anchor_generator.py:709-731)."""

    def __init__(self, strides, ratios, basesize_ratio_range,
                 input_size=300, scale_major: bool = True):
        super().__init__(strides=strides, ratios=ratios,
                         basesize_ratio_range=basesize_ratio_range,
                         input_size=input_size, scale_major=scale_major)
        self.centers = [((s[0] - 1) / 2., (s[1] - 1) / 2.)
                        for s in self.strides]
        self.base_anchors = self.gen_base_anchors()


@PRIOR_GENERATORS.register_module()
class YOLOAnchorGenerator(AnchorGenerator):
    """YOLO anchors: explicit per-level (w, h) base sizes, cell-center
    offsets, GT-responsible cell flags (reference
    anchor_generator.py:734-866)."""

    def __init__(self, strides, base_sizes):
        self.strides = [_pair(s) for s in strides]
        self.centers = [(s[0] / 2., s[1] / 2.) for s in self.strides]
        self.base_sizes = [[_pair(bs) for bs in per_level]
                           for per_level in base_sizes]
        self.base_anchors = self.gen_base_anchors()

    @property
    def num_levels(self) -> int:
        return len(self.base_sizes)

    def gen_base_anchors(self) -> List[np.ndarray]:
        out = []
        for i, sizes in enumerate(self.base_sizes):
            x_c, y_c = self.centers[i]
            anchors = [[x_c - 0.5 * w, y_c - 0.5 * h,
                        x_c + 0.5 * w, y_c + 0.5 * h]
                       for (w, h) in sizes]
            out.append(np.asarray(anchors, np.float32))
        return out

    def responsible_flags(self, featmap_sizes, gt_bboxes: torch.Tensor,
                          gt_valid: Optional[torch.Tensor] = None
                          ) -> List[torch.Tensor]:
        """Flags of cells containing a (valid) GT center, per level, on the
        GTs' device (reference :770-866)."""
        out = []
        cx = (gt_bboxes[:, 0] + gt_bboxes[:, 2]) * 0.5
        cy = (gt_bboxes[:, 1] + gt_bboxes[:, 3]) * 0.5
        for i, (feat_h, feat_w) in enumerate(featmap_sizes):
            sw, sh = self.strides[i]
            gx = torch.floor(cx / sw).long()
            gy = torch.floor(cy / sh).long()
            idx = torch.clamp(gy * feat_w + gx, 0, feat_h * feat_w - 1)
            add = torch.ones(idx.shape, dtype=torch.int32,
                             device=idx.device) if gt_valid is None \
                else gt_valid.to(torch.int32)
            grid = torch.zeros((feat_h * feat_w,), dtype=torch.int32,
                               device=idx.device).scatter_reduce(
                0, idx, add, 'amax')
            out.append(torch.repeat_interleave(grid.bool(),
                                               self.num_base_priors[i]))
        return out
