"""CondInst / BoxInst heads (NCHW), counterpart of
``boxinstseg_tpu/models/dense_heads/condinst_head.py`` (reference:
mmdet/models/dense_heads/condinst_head.py).

- ``CondInstBoxHead``: FCOS towers shared across levels; returns the tower
  outputs plus the regression-tower features that feed the dynamic-param
  conv, which lives in ``CondInstMaskHead.param_conv`` as in the reference
  checkpoints (``mask_head.param_conv``).
- ``CondInstSegmHead``: the optional semantic head of fully supervised
  CondInst on P3, and its min-area focal loss.
- ``CondInstMaskBranch``: fuses P3-P5 into a stride-8 mask feature map.
- ``CondInstMaskHead``: dynamic-conv mask decoder (batched einsums over the
  sampled instances) and the BoxInst losses; the pairwise term goes
  through ``ops.pairwise.boxinst_pairwise_loss``, which launches the CUDA
  kernels for a CUDA tensor and the plain version for a CPU tensor.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import (Conv2d, ConvModule, Scale, bias_init_with_prob,
                      normal_init_)
from ..losses.focal_loss import sigmoid_focal_loss
from ..losses.projection import compute_project_term
from ...core.targets.fcos import INF, FcosTargets, fcos_targets
from ...ops.boxes import distance2bbox
from ...ops.color import image_color_similarity, srgb_uint8_to_lab
from ...ops.pairwise import boxinst_pairwise_loss
from ...ops.points import concat_points_and_meta
from ...ops.upsample import aligned_bilinear, avg_pool_stride
from ...parallel import dist as pdist
from ...registry import HEADS, LOSSES
from ...utils.profiling import span

DEFAULT_REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512),
                          (512, INF))


def flatten_levels(per_level: List[torch.Tensor]) -> torch.Tensor:
    """[(B, C, H, W)] -> (B, P, C), level-major and row-major inside a
    level, like the reference's per-level concatenation."""
    return torch.cat([x.flatten(2).transpose(1, 2) for x in per_level], 1)


@HEADS.register_module()
class CondInstBoxHead(nn.Module):
    """FCOS-style box head (reference: CondInstBoxHead,
    condinst_head.py:250-876)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 regress_ranges: Sequence = DEFAULT_REGRESS_RANGES,
                 center_sampling: bool = True,
                 center_sample_radius: float = 1.5,
                 norm_on_bbox: bool = True, centerness_on_reg: bool = False,
                 loss_cls: Optional[dict] = None,
                 loss_bbox: Optional[dict] = None,
                 loss_centerness: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None, conv_bias: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.regress_ranges = regress_ranges
        self.center_sampling = center_sampling
        self.center_sample_radius = center_sample_radius
        self.norm_on_bbox = norm_on_bbox
        self.centerness_on_reg = centerness_on_reg
        norm = norm_cfg or dict(type='GN', num_groups=32)

        def tower():
            return nn.ModuleList(
                ConvModule(in_channels if i == 0 else feat_channels,
                           feat_channels, 3, 1, 1, norm_cfg=norm,
                           bias=conv_bias, init_std=0.01)
                for i in range(stacked_convs))

        self.cls_convs = tower()
        self.reg_convs = tower()
        self.conv_cls = normal_init_(
            Conv2d(feat_channels, num_classes, 3, 1, 1), 0.01,
            bias_init_with_prob(0.01))
        self.conv_reg = normal_init_(Conv2d(feat_channels, 4, 3, 1, 1), 0.01)
        self.conv_centerness = normal_init_(
            Conv2d(feat_channels, 1, 3, 1, 1), 0.01)
        self.scales = nn.ModuleList(Scale(1.0) for _ in self.strides)
        self.loss_cls = LOSSES.build(loss_cls or dict(
            type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0))
        self.loss_bbox = LOSSES.build(loss_bbox or dict(
            type='GIoULoss', loss_weight=1.0))
        self.loss_centerness = LOSSES.build(loss_centerness or dict(
            type='CrossEntropyLoss', use_sigmoid=True, loss_weight=1.0))

    def forward(self, feats):
        """feats: tuple of (B, C, H, W). Returns per-level lists: cls
        (B, num_classes, H, W), bbox (B, 4, H, W), ctr (B, 1, H, W) and
        reg_feat (B, feat_channels, H, W)."""
        outs = {'cls': [], 'bbox': [], 'ctr': [], 'reg_feat': []}
        for lvl, x in enumerate(feats):
            cls_feat = x
            for m in self.cls_convs:
                cls_feat = m(cls_feat)
            reg_feat = x
            for m in self.reg_convs:
                reg_feat = m(reg_feat)
            bbox_pred = self.scales[lvl](self.conv_reg(reg_feat)).float()
            if self.norm_on_bbox:
                bbox_pred = F.relu(bbox_pred)
                if not self.training:
                    bbox_pred = bbox_pred * self.strides[lvl]
            else:
                bbox_pred = torch.exp(bbox_pred)
            ctr_feat = reg_feat if self.centerness_on_reg else cls_feat
            outs['cls'].append(self.conv_cls(cls_feat))
            outs['bbox'].append(bbox_pred)
            outs['ctr'].append(self.conv_centerness(ctr_feat))
            outs['reg_feat'].append(reg_feat)
        return outs

    def points_meta(self, featmap_sizes, device):
        return concat_points_and_meta(featmap_sizes, self.strides,
                                      regress_ranges=self.regress_ranges,
                                      device=device)

    def loss(self, outs: Dict[str, List[torch.Tensor]], gt_bboxes,
             gt_labels, gt_valid
             ) -> Tuple[Dict[str, torch.Tensor], FcosTargets, dict]:
        """Box losses over the batch; the normalisers are the global
        batch's under a process group (``parallel.dist``)."""
        with span('loss.targets'):
            featmap_sizes = [tuple(x.shape[-2:]) for x in outs['cls']]
            pts = self.points_meta(featmap_sizes, gt_bboxes.device)
            targets = fcos_targets(
                pts['points'], pts['strides'], pts['regress_ranges'],
                gt_bboxes, gt_labels, gt_valid, self.num_classes,
                self.center_sampling, self.center_sample_radius,
                self.norm_on_bbox)

        with span('loss.box'):
            cls = flatten_levels(outs['cls'])               # (B, P, C)
            bbox = flatten_levels(outs['bbox'])             # (B, P, 4)
            ctr = flatten_levels(outs['ctr'])[..., 0]       # (B, P)

            is_pos = targets.labels < self.num_classes
            num_pos = pdist.reduce_mean_denominator(is_pos.sum().float(),
                                                    1.0)
            loss_cls = self.loss_cls(cls, targets.labels,
                                     avg_factor=num_pos)

            pos_w = is_pos.float()
            ctr_targets = targets.centerness
            ctr_denorm = pdist.reduce_mean_denominator(
                (ctr_targets * pos_w).sum(), 1e-6)
            points = pts['points'][None]                    # (1, P, 2)
            loss_bbox = self.loss_bbox(
                distance2bbox(points, bbox),
                distance2bbox(points, targets.bbox_targets),
                weight=ctr_targets * pos_w, avg_factor=ctr_denorm)
            loss_ctr = self.loss_centerness(ctr, ctr_targets, weight=pos_w,
                                            avg_factor=num_pos)
            losses = dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                          loss_centerness=loss_ctr)
        return losses, targets, pts


@HEADS.register_module()
class CondInstSegmHead(nn.Module):
    """Auxiliary semantic head (reference: CondInstSegmHead,
    condinst_head.py:878-968): ``stacked_convs`` 3x3 ``ConvModule``s with
    BN over the global batch (``segm_branch.{i}``), then a 1x1 conv to the
    class logits with the focal prior's bias (``segm_conv``)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 in_stride: int = 8, stacked_convs: int = 2,
                 feat_channels: int = 128, loss_segm: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.num_classes = num_classes
        self.in_stride = in_stride
        norm = norm_cfg or dict(type='BN')
        self.segm_branch = nn.Sequential(*(
            ConvModule(in_channels if i == 0 else feat_channels,
                       feat_channels, 3, 1, 1, norm_cfg=norm)
            for i in range(stacked_convs)))
        self.segm_conv = Conv2d(feat_channels, num_classes, 1, 1, 0)
        nn.init.constant_(self.segm_conv.bias, bias_init_with_prob(0.01))

    def forward(self, x):
        """(B, C, H, W) P3 features -> (B, num_classes, H, W) logits."""
        return self.segm_conv(self.segm_branch(x))

    def loss(self, segm_pred: torch.Tensor, gt_masks: torch.Tensor,
             gt_labels: torch.Tensor, gt_valid: torch.Tensor,
             mask_stride: int) -> Dict[str, torch.Tensor]:
        """Sigmoid focal loss against min-area semantic targets (reference
        get_targets, condinst_head.py:940-968): each pixel takes the label
        of the smallest valid GT mask that covers it, or the background.

        segm_pred: (B, C, Hs, Ws) at ``in_stride``; gt_masks: (B, G, H, W)
        binary at ``mask_stride``, sampled at ``start::step`` with ``step =
        in_stride // mask_stride`` and ``start = step // 2``. The loss is
        over the positive pixels of the global batch
        (``parallel.dist.reduce_mean_denominator``)."""
        b, c, hs, ws = segm_pred.shape
        step = self.in_stride // mask_stride
        start = step // 2
        areas = gt_masks.sum(dim=(2, 3)).float()[..., None, None]
        grid = gt_masks[:, :, start::step, start::step][:, :, :hs, :ws]
        areas = torch.where((grid > 0) & gt_valid[..., None, None], areas,
                            torch.full_like(areas, float('inf')))
        min_idx = torch.argmin(areas, dim=1)                    # (B, hs, ws)
        covered = torch.isfinite(torch.gather(areas, 1, min_idx[:, None]))
        labels = torch.gather(
            gt_labels.long()[..., None, None].expand(-1, -1, *grid.shape[2:]),
            1, min_idx[:, None])
        labels = torch.where(covered, labels, torch.full_like(
            labels, self.num_classes))[:, 0]
        num_pos = pdist.reduce_mean_denominator(
            (labels != self.num_classes).sum().float(), 1.0)
        loss = sigmoid_focal_loss(segm_pred.permute(0, 2, 3, 1), labels,
                                  self.num_classes, avg_factor=num_pos)
        return dict(loss_segm=loss)


@HEADS.register_module()
class CondInstMaskBranch(nn.Module):
    """Fuses P3-P5 into a stride-8 mask feature map (reference:
    CondInstMaskBranch, condinst_head.py:972-1038)."""

    def __init__(self, in_channels: int = 256,
                 in_indices: Sequence[int] = (0, 1, 2),
                 strides: Sequence[int] = (8, 16, 32),
                 branch_convs: int = 4, branch_channels: int = 128,
                 branch_out_channels: int = 16,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        norm = norm_cfg or dict(type='BN')
        self.in_indices = tuple(in_indices)
        self.strides = tuple(strides)
        self.refines = nn.ModuleList(
            ConvModule(in_channels, branch_channels, 3, 1, 1, norm_cfg=norm)
            for _ in self.in_indices)
        layers = [ConvModule(branch_channels, branch_channels, 3, 1, 1,
                             norm_cfg=norm) for _ in range(branch_convs)]
        layers.append(Conv2d(branch_channels, branch_out_channels, 1, 1, 0))
        self.mask_branch = nn.Sequential(*layers)

    def forward(self, feats):
        mask_stride = self.strides[0]
        x = self.refines[0](feats[self.in_indices[0]])
        for i in range(1, len(self.in_indices)):
            p = self.refines[i](feats[self.in_indices[i]])
            x = x + aligned_bilinear(p, self.strides[i] // mask_stride)
        return self.mask_branch(x)


@HEADS.register_module()
class CondInstMaskHead(nn.Module):
    """Dynamic-conv mask decoder + BoxInst losses (reference:
    CondInstMaskHead, condinst_head.py:1042-1448). Its one trainable layer
    is ``param_conv``, which turns the box head's regression features into
    the per-location dynamic-conv parameters."""

    def __init__(self, in_channels: int = 16, in_stride: int = 8,
                 out_stride: int = 4, dynamic_convs: int = 3,
                 dynamic_channels: int = 8, disable_rel_coors: bool = False,
                 bbox_head_channels: int = 256,
                 sizes_of_interest: Sequence[int] = (64, 128, 256, 512,
                                                     1024),
                 max_proposals: int = -1, topk_per_img: int = 64,
                 boxinst_enabled: bool = True,
                 bottom_pixels_removed: int = 10, pairwise_size: int = 3,
                 pairwise_dilation: int = 2,
                 pairwise_color_thresh: float = 0.3,
                 pairwise_warmup: int = 10000,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.in_channels = in_channels
        self.in_stride = in_stride
        self.out_stride = out_stride
        self.dynamic_convs = dynamic_convs
        self.dynamic_channels = dynamic_channels
        self.disable_rel_coors = disable_rel_coors
        self.sizes_of_interest = tuple(sizes_of_interest)
        self.max_proposals = max_proposals
        self.topk_per_img = topk_per_img
        self.boxinst_enabled = boxinst_enabled
        self.bottom_pixels_removed = bottom_pixels_removed
        self.pairwise_size = pairwise_size
        self.pairwise_dilation = pairwise_dilation
        self.pairwise_color_thresh = pairwise_color_thresh
        self.pairwise_warmup = pairwise_warmup

        dyn_in = in_channels if disable_rel_coors else in_channels + 2
        self.dy_weights, self.dy_biases = [], []
        for i in range(dynamic_convs):
            in_chn = dyn_in if i == 0 else dynamic_channels
            out_chn = 1 if i == dynamic_convs - 1 else dynamic_channels
            self.dy_weights.append(in_chn * out_chn)
            self.dy_biases.append(out_chn)
        self.num_gen_params = sum(self.dy_weights) + sum(self.dy_biases)
        self.param_conv = normal_init_(
            Conv2d(bbox_head_channels, self.num_gen_params, 3, 1, 1), 0.01)

    @property
    def capacity(self) -> int:
        """Static per-image instance capacity for training sampling."""
        if self.topk_per_img != -1:
            return self.topk_per_img
        return max(self.max_proposals, 1)

    def parse_params(self, params: torch.Tensor):
        """(..., num_gen_params) -> lists of (..., out, in) weights and
        (..., out) biases, torch layout (condinst_head.py:1120-1137)."""
        sizes = self.dy_weights + self.dy_biases
        offsets = np.cumsum([0] + sizes)
        pieces = [params[..., offsets[i]:offsets[i + 1]]
                  for i in range(len(sizes))]
        weights, biases = [], []
        dyn_in = self.in_channels + (0 if self.disable_rel_coors else 2)
        for i in range(self.dynamic_convs):
            in_chn = dyn_in if i == 0 else self.dynamic_channels
            out_chn = (1 if i == self.dynamic_convs - 1
                       else self.dynamic_channels)
            weights.append(pieces[i].reshape(params.shape[:-1]
                                             + (out_chn, in_chn)))
            biases.append(pieces[self.dynamic_convs + i])
        return weights, biases

    def decode(self, mask_feat: torch.Tensor, params: torch.Tensor,
               coors: torch.Tensor, level_inds: torch.Tensor
               ) -> torch.Tensor:
        """Decode per-instance masks.

        Args:
          mask_feat: (B, C, Hm, Wm) stride-``in_stride`` features.
          params: (B, K, num_gen_params); coors: (B, K, 2) xy of the
          generating location; level_inds: (B, K) FPN level per instance.
        Returns:
          (B, K, Ho, Wo) logits at ``out_stride``.

        The reference's grouped 1x1 convs become batched einsums over the
        (B, K) instance axes; the intermediate layout is (B, K, O, H, W).
        """
        B, C, Hm, Wm = mask_feat.shape
        weights, biases = self.parse_params(params)
        if self.disable_rel_coors:
            x = torch.einsum('bchw,bkoc->bkohw', mask_feat, weights[0])
        else:
            # rel-coord channels come FIRST in the dynamic conv input
            # (condinst_head.py:1151: cat([rel_coors, mask_feat])), x
            # before y (condinst_head.py:1147)
            dev = mask_feat.device
            xs = (torch.arange(Wm, device=dev, dtype=torch.float32)
                  * self.in_stride + self.in_stride // 2)
            ys = (torch.arange(Hm, device=dev, dtype=torch.float32)
                  * self.in_stride + self.in_stride // 2)
            soi = torch.tensor(self.sizes_of_interest, dtype=torch.float32,
                               device=dev)[level_inds]          # (B, K)
            rel_x = (coors[..., 0][..., None] - xs) / soi[..., None]
            rel_y = (coors[..., 1][..., None] - ys) / soi[..., None]
            w_rel = weights[0][..., :2]                          # (B,K,O,2)
            w_feat = weights[0][..., 2:]                         # (B,K,O,C)
            x = torch.einsum('bchw,bkoc->bkohw', mask_feat, w_feat)
            x = x + _rel_contrib(rel_y, rel_x, w_rel)
        x = F.relu(x + biases[0][..., None, None])
        for i in range(1, self.dynamic_convs):
            x = torch.einsum('bkihw,bkoi->bkohw', x, weights[i])
            x = x + biases[i][..., None, None]
            if i < self.dynamic_convs - 1:
                x = F.relu(x)
        x = aligned_bilinear(x, self.in_stride // self.out_stride)
        return x[:, :, 0]

    # ---- BoxInst targets ---------------------------------------------------
    def color_similarity_targets(self, images, img_norm_mean, img_norm_std,
                                 img_shapes, pixels_removed):
        """Per-image Lab colour similarity at out_stride (reference:
        get_bitmasks_from_boxes, condinst_head.py:1395-1425).

        Args:
          images: (B, 3, H, W) normalised RGB input canvas.
          img_shapes: (B, 2) int (h, w) valid region.
          pixels_removed: (B,) int bottom rows to blank.
        Returns:
          similarity (B, K^2-1, Hs, Ws), image_mask_s (B, Hs, Ws).
        """
        B, _, H, W = images.shape
        stride = self.out_stride
        dev = images.device
        mean = torch.tensor(img_norm_mean, dtype=torch.float32, device=dev)
        std = torch.tensor(img_norm_std, dtype=torch.float32, device=dev)
        rows = torch.arange(H, device=dev)[None, :]
        cols = torch.arange(W, device=dev)[None, :]
        row_in = (rows < img_shapes[:, 0][:, None]).float()
        col_in = (cols < img_shapes[:, 1][:, None]).float()

        # avg_pool((img*std + mean) * region)
        #   = std * avg_pool(img * region) + mean * avg_pool(region),
        # and region is an outer product of 1-D bounds
        region = row_in[:, :, None] * col_in[:, None, :]
        pool_img = avg_pool_stride(images.float() * region[:, None], stride)
        pool_row = row_in.reshape(B, H // stride, stride).mean(-1)
        pool_col = col_in.reshape(B, W // stride, stride).mean(-1)
        pool_reg = pool_row[:, :, None] * pool_col[:, None, :]
        down = pool_img * std[:, None, None] \
            + mean[:, None, None] * pool_reg[:, None]

        # image_mask = region & (row < h - pixels_removed), sampled at the
        # stride grid points
        start = stride // 2
        rows_s = (start + stride * torch.arange(H // stride,
                                                device=dev))[None, :]
        cols_s = (start + stride * torch.arange(W // stride,
                                                device=dev))[None, :]
        rm = rows_s < (img_shapes[:, 0] - pixels_removed)[:, None]
        cm = cols_s < img_shapes[:, 1][:, None]
        mask_s = (rm[:, :, None] & cm[:, None, :]).float()
        sim = image_color_similarity(srgb_uint8_to_lab(down), mask_s,
                                     self.pairwise_size,
                                     self.pairwise_dilation)
        return sim, mask_s

    def box_bitmasks(self, boxes: torch.Tensor, out_h: int, out_w: int
                     ) -> torch.Tensor:
        """(B, K, 4) boxes -> (B, K, out_h, out_w) bitmasks sampled at the
        out_stride grid points, replicating the reference's integer-
        truncated inclusive box fill (condinst_head.py:1427-1443)."""
        stride = self.out_stride
        start = stride // 2
        dev = boxes.device
        xs = (start + stride * torch.arange(out_w, device=dev)).float()
        ys = (start + stride * torch.arange(out_h, device=dev)).float()
        x1, y1, x2, y2 = (torch.floor(boxes[..., i])[..., None]
                          for i in range(4))
        col_in = (xs >= x1) & (xs <= x2)          # (B, K, W)
        row_in = (ys >= y1) & (ys <= y2)          # (B, K, H)
        return (row_in[..., :, None] & col_in[..., None, :]).float()

    def loss(self, mask_logits, sampled_boxes, sample_valid, color_sim,
             iteration) -> Dict[str, torch.Tensor]:
        """BoxInst mask losses over the sampled instances.

        Args:
          mask_logits: (B, K, Ho, Wo) from ``decode``.
          sampled_boxes: (B, K, 4) GT boxes of each sample.
          sample_valid: (B, K) bool.
          color_sim: (B, K^2-1, Ho, Wo) from ``color_similarity_targets``.
          iteration: the pairwise warmup counter (int or 0-dim tensor).
        """
        B, K, Ho, Wo = mask_logits.shape
        bitmasks = self.box_bitmasks(sampled_boxes.detach(), Ho, Wo)
        color_sim = color_sim.detach()

        mask_scores = torch.sigmoid(mask_logits)
        loss_prj = compute_project_term(
            mask_scores.reshape(B * K, Ho, Wo),
            bitmasks.reshape(B * K, Ho, Wo), valid=sample_valid.reshape(-1))
        loss_pairwise = boxinst_pairwise_loss(
            mask_logits, color_sim, bitmasks, sample_valid,
            self.pairwise_color_thresh, self.pairwise_size,
            self.pairwise_dilation)
        warmup = min(float(iteration) / float(self.pairwise_warmup), 1.0)
        return dict(loss_prj=loss_prj, loss_pairwise=loss_pairwise * warmup)


def _rel_contrib(rel_y, rel_x, w_rel):
    """First-layer contribution of the (x, y) rel-coord channels.

    rel_x: (B, K, Wm); rel_y: (B, K, Hm); w_rel: (B, K, O, 2) where channel
    0 multiplies x and channel 1 multiplies y. Returns (B, K, O, Hm, Wm).
    """
    wx = w_rel[..., 0][..., None, None]        # (B, K, O, 1, 1)
    wy = w_rel[..., 1][..., None, None]
    tx = rel_x[:, :, None, None, :] * wx       # (B, K, O, 1, Wm)
    ty = rel_y[:, :, None, :, None] * wy       # (B, K, O, Hm, 1)
    return tx + ty
