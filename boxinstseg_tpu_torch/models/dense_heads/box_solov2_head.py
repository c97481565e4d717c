"""BoxLevelset head (NCHW), counterpart of
``boxinstseg_tpu/models/dense_heads/box_solov2_head.py`` (reference:
mmdet/models/dense_heads/box_solov2_head.py).

- Grid kernels and categories: the five levels (P2 halved, P6 resized to
  P5's size), coordinates on the kernel branch, both branches resized to
  the grid at ``cate_down_pos``;
- the unified stride-4 feature from P2-P5 (``max(i, 1)`` convs at level i,
  each followed by a x2 upsample at i > 0, coordinates on P5, no norm and
  no bias), then ``solo_mask`` and the 5-channel ``levelset_bottom``;
- losses: focal over the grid, the box projection term, the image
  level-set term at stride 4 (x0.05) and the tree-filtered structural
  term at ``tf_size`` (x5.0) over the minimum spanning trees of the image
  and of the level-set feature (``ops.tree_filter``);
- prediction: ``solo_common.solo_get_seg`` (matrix NMS).

Module and parameter names follow the mmdet reference (``kernel_convs.i``,
``cate_convs.i``, ``feature_convs.i.convj``, ``solo_cate``,
``solo_kernel``, ``solo_mask``, ``levelset_bottom``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..layers import Conv2d, ConvModule, bias_init_with_prob, normal_init_
from ..losses.levelset_loss import region_levelset, region_levelset_shared
from .solo_common import coord_feat, decode_masks, solo_get_seg
from ...core.targets.solo import sample_positive_cells, solo_targets
from ...ops.nms import points_nms_2x2
from ...ops.tree_filter import grid_mst_pair, tree_filter2d
from ...ops.upsample import interpolate_bilinear
from ...parallel import dist as pdist
from ...registry import HEADS, LOSSES


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@HEADS.register_module()
class BoxSOLOv2Head(nn.Module):

    def __init__(self, num_classes: int, in_channels: int = 256,
                 seg_feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 8, 16, 32, 32),
                 base_edge_list: Sequence[int] = (16, 32, 64, 128, 256),
                 scale_ranges: Sequence = ((1, 96), (48, 192), (96, 384),
                                           (192, 768), (384, 2048)),
                 sigma: float = 0.2,
                 num_grids: Sequence[int] = (40, 36, 24, 16, 12),
                 cate_down_pos: int = 0,
                 loss_cate: Optional[dict] = None,
                 loss_boxpro: Optional[dict] = None,
                 loss_levelset: Optional[dict] = None,
                 conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 use_dcn_in_tower: bool = False,
                 type_dcn: Optional[str] = None,
                 init_cfg: Optional[dict] = None, max_pos: int = 196,
                 tf_size: Tuple[int, int] = (96, 96), tf_max_depth: int = 0,
                 levelset_feat_channels: int = 5):
        super().__init__()
        if use_dcn_in_tower:
            raise NotImplementedError('deformable tower convs are not '
                                      'ported yet')
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.scale_ranges = tuple(tuple(r) for r in scale_ranges)
        self.sigma = sigma
        self.num_grids = tuple(num_grids)
        self.cate_down_pos = cate_down_pos
        self.loss_cate = loss_cate
        self.loss_boxpro = loss_boxpro
        self.loss_levelset = loss_levelset
        self.max_pos = max_pos
        self.tf_size = tuple(tf_size)
        self.tf_max_depth = tf_max_depth
        ch = seg_feat_channels
        gn = dict(type='GN', num_groups=min(32, ch))

        def tower(first_in):
            return nn.ModuleList(ConvModule(
                first_in if i == 0 else ch, ch, 3, 1, 1, norm_cfg=gn,
                bias=False, init_std=0.01) for i in range(stacked_convs))

        self.kernel_convs = tower(in_channels + 2)
        self.cate_convs = tower(in_channels)
        self.solo_cate = normal_init_(Conv2d(ch, num_classes, 3, 1, 1), 0.01,
                                      bias_init_with_prob(0.01))
        self.solo_kernel = normal_init_(Conv2d(ch, ch, 1, 1, 0), 0.01)
        # the feature convs have no norm and no bias (the reference's
        # ``bias=norm_cfg is None`` with its local GN dict)
        self.feature_convs = nn.ModuleList()
        for i in range(4):
            level = nn.Module()
            for j in range(max(i, 1)):
                cin = ch if j else in_channels + (2 if i == 3 else 0)
                level.add_module(f'conv{j}', ConvModule(
                    cin, ch, 3, 1, 1, bias=False, init_std=0.01))
            self.feature_convs.append(level)
        self.solo_mask = normal_init_(Conv2d(ch, ch, 1, 1, 0), 0.01)
        self.levelset_bottom = normal_init_(
            Conv2d(ch, levelset_feat_channels, 3, 1, 1), 0.01)

    def forward(self, feats, train: bool = True
                ) -> Dict[str, torch.Tensor]:
        """FPN P2-P6 -> kernels (B, Pc, E) and cates (B, Pc, C), cells
        level-major; mask_feat (B, E, H/4, W/4) and levelset_feat (B, 5,
        H/4, W/4). With ``train`` the cates are logits; without it they are
        sigmoid scores after the points NMS."""
        b = feats[0].shape[0]
        p2h, p2w = feats[0].shape[-2:]
        new_feats = [interpolate_bilinear(feats[0], (p2h // 2, p2w // 2)),
                     feats[1], feats[2], feats[3],
                     interpolate_bilinear(feats[4], feats[3].shape[-2:])]
        kernels, cates = [], []
        for x, s in zip(new_feats, self.num_grids):
            kfeat = torch.cat([x, coord_feat(b, x.shape[2], x.shape[3],
                                              x.device)], dim=1)
            cfeat = x
            for i, (kconv, cconv) in enumerate(zip(self.kernel_convs,
                                                   self.cate_convs)):
                if i == self.cate_down_pos:
                    kfeat = interpolate_bilinear(kfeat, (s, s))
                    cfeat = interpolate_bilinear(cfeat, (s, s))
                kfeat = kconv(kfeat)
                cfeat = cconv(cfeat)
            cate = self.solo_cate(cfeat)
            if not train:
                cate = points_nms_2x2(torch.sigmoid(cate.float()))
            kernels.append(self.solo_kernel(kfeat).flatten(2).transpose(1, 2))
            cates.append(cate.flatten(2).transpose(1, 2))

        target_hw = tuple(feats[0].shape[-2:])
        feat_sum = None
        for i, level in enumerate(self.feature_convs):
            x = feats[i]
            if i == 3:
                x = torch.cat([x, coord_feat(b, x.shape[2], x.shape[3],
                                              x.device)], dim=1)
            for conv in level.children():
                x = conv(x)
                if i > 0:
                    x = interpolate_bilinear(x, (x.shape[2] * 2,
                                                 x.shape[3] * 2))
            if tuple(x.shape[-2:]) != target_hw:
                x = interpolate_bilinear(x, target_hw)
            feat_sum = x if feat_sum is None else feat_sum + x
        mask_feat = self.solo_mask(feat_sum)
        return dict(kernels=torch.cat(kernels, dim=1),
                    cates=torch.cat(cates, dim=1), mask_feat=mask_feat,
                    levelset_feat=self.levelset_bottom(mask_feat))

    def loss(self, outs: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """batch: image (B, 3, H, W), gt_bboxes, gt_labels, gt_valid,
        gt_masks (B, G, H/4, W/4) box bitmasks."""
        loss_cate_fn = LOSSES.build(self.loss_cate or dict(
            type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0))
        loss_boxpro_fn = LOSSES.build(self.loss_boxpro or dict(
            type='BoxProjectionLoss', loss_weight=3.0))
        levelset_weight = (self.loss_levelset or {}).get('loss_weight', 1.0)

        img = batch['image'].detach()
        bsz, _, hh, ww = img.shape
        targets = solo_targets(
            batch['gt_bboxes'], batch['gt_labels'], batch['gt_valid'],
            batch['gt_masks'], (hh, ww), self.num_grids, self.scale_ranges,
            self.sigma, self.num_classes, mask_stride=4)
        loss_cate = loss_cate_fn(outs['cates'], targets.cate_labels,
                                 avg_factor=pdist.reduce_mean_denominator(
                                     targets.num_pos.float(), offset=1.0))

        cell_idx, gt_idx, valid = sample_positive_cells(targets.cell_gt,
                                                        self.max_pos)
        e = outs['kernels'].shape[-1]
        kernels = torch.gather(outs['kernels'], 1,
                               cell_idx[..., None].expand(-1, -1, e))
        mask_scores = torch.sigmoid(decode_masks(outs['mask_feat'], kernels))
        k, h4, w4 = mask_scores.shape[1:]
        box_mask = torch.gather(
            batch['gt_masks'].float(), 1,
            gt_idx[:, :, None, None].expand(-1, -1, h4, w4))
        vmask = valid.float()
        denom = pdist.reduce_mean_denominator(vmask.sum(), 1.0)

        prj = loss_boxpro_fn(mask_scores.reshape(bsz * k, h4, w4),
                             box_mask.reshape(bsz * k, h4, w4),
                             valid=valid.reshape(-1))
        loss_project = prj.sum() / denom

        # the image term at stride 4 against the image shared by the
        # image's instances
        pixel_num = torch.clamp(box_mask.sum(dim=(2, 3)), min=1.0)
        ls_img = region_levelset_shared(
            mask_scores, box_mask, interpolate_bilinear(img, (h4, w4))
        ) / pixel_num

        # the structural term at tf_size: the scores filtered over the
        # image's tree, then over the level-set feature's
        th, tw = self.tf_size
        img_tf = interpolate_bilinear(img, (th, tw))
        lst_tf = interpolate_bilinear(outs['levelset_feat'], (th, tw))
        mask_tf = interpolate_bilinear(mask_scores, (th, tw))
        box_tf = interpolate_bilinear(box_mask, (th, tw))
        tf_md = self.tf_max_depth or th * tw
        (parent_i, depth_i), (parent_l, depth_l) = grid_mst_pair(
            _nhwc(img_tf), _nhwc(lst_tf), tf_md)
        deep_img = tree_filter2d(_nhwc(mask_tf), _nhwc(img_tf), parent_i,
                                 depth_i, sigma=0.02, low_tree=True,
                                 max_depth=tf_md)
        deep_lst = tree_filter2d(deep_img, _nhwc(lst_tf), parent_l, depth_l,
                                 low_tree=False, max_depth=tf_md)
        high = torch.stack([deep_img, deep_lst], dim=1).permute(
            0, 4, 1, 2, 3) * box_tf[:, :, None]                 # (B,K,2,t,t)
        phi_tf = torch.stack([mask_tf, 1.0 - mask_tf], dim=2) \
            * box_tf[:, :, None]
        pixel_tf = torch.clamp(box_tf.sum(dim=(2, 3)), min=1.0)
        ls_high = region_levelset(
            phi_tf.reshape(bsz * k, 2, th, tw),
            high.reshape(bsz * k, 2, th, tw)) / pixel_tf.reshape(-1)

        loss_levelset = levelset_weight * (
            0.05 * (ls_img * vmask).sum()
            + 5.0 * (ls_high * vmask.reshape(-1)).sum()) / denom
        return dict(loss_cate=loss_cate, loss_boxpro=loss_project,
                    loss_levelset=loss_levelset)

    def get_seg(self, outs: Dict[str, torch.Tensor],
                test_cfg: Optional[Dict]) -> Dict[str, torch.Tensor]:
        """Prediction from the ``train=False`` outputs (reference
        get_seg_single, box_solov2_head.py:503-590): ``solo_get_seg`` with
        BoxLevelset's defaults."""
        cfg = dict(test_cfg or {})
        return solo_get_seg(
            outs['cates'], outs['kernels'], outs['mask_feat'],
            self.num_grids, self.strides,
            score_thr=float(cfg.get('score_thr', 0.05)),
            mask_thr=float(cfg.get('mask_thr', 0.55)),
            filter_thr=float(cfg.get('filter_thr', 0.025)),
            nms_pre=int(cfg.get('nms_pre', 500)),
            max_per_img=int(cfg.get('max_per_img', 100)),
            kernel=cfg.get('kernel', 'gaussian'),
            sigma=float(cfg.get('sigma', 2.0)))
