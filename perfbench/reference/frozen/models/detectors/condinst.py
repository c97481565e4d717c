"""CondInst / BoxInst detector, counterpart of
``boxinstseg_tpu/models/detectors/condinst.py`` (reference:
mmdet/models/detectors/condinst.py): backbone -> FPN -> box head -> mask
branch -> dynamic mask head. ``loss`` is the full BoxInst training
objective on a static-shape batch. Only what the benchmark's cells run is
copied: no predict (no BoxInst predict cell), no fully supervised
CondInst (its dice and semantic losses); a cell that needs either copies
it in.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..dense_heads.condinst_head import flatten_levels
from ..layers import f32_tree, fp32_region
from ...core.targets.fcos import sample_positives_per_gt
from ...registry import BACKBONES, DETECTORS, HEADS, NECKS

DEFAULT_MEAN = (123.675, 116.28, 103.53)
DEFAULT_STD = (58.395, 57.12, 57.375)


@DETECTORS.register_module()
class CondInst(nn.Module):
    def __init__(self, backbone: dict, neck: Optional[dict] = None,
                 bbox_head: Optional[dict] = None,
                 mask_branch: Optional[dict] = None,
                 mask_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None,
                 img_norm_mean: Sequence[float] = DEFAULT_MEAN,
                 img_norm_std: Sequence[float] = DEFAULT_STD):
        super().__init__()
        self.backbone = BACKBONES.build(backbone)
        self.neck = NECKS.build(neck) if neck else None
        self.bbox_head = HEADS.build(bbox_head)
        self.mask_branch = HEADS.build(mask_branch)
        # param_conv reads the box head's regression tower, as the JAX
        # package's box head does
        mask_cfg = dict(mask_head)
        mask_cfg['bbox_head_channels'] = bbox_head.get('feat_channels', 256)
        self.mask_head = HEADS.build(mask_cfg)
        self.test_cfg = test_cfg
        self.img_norm_mean = tuple(img_norm_mean)
        self.img_norm_std = tuple(img_norm_std)

    def extract_feat(self, images):
        x = self.backbone(images)
        if self.neck is not None:
            x = self.neck(x)
        return x

    def forward(self, images):
        """Plain forward: box-head outputs (with the dynamic params under
        'param') and the mask-branch features."""
        return self._forward(self.extract_feat(images))

    def _forward(self, feats):
        outs = self.bbox_head(feats)
        outs['param'] = [self.mask_head.param_conv(f)
                         for f in outs.pop('reg_feat')]
        return outs, self.mask_branch(feats)

    # ------------------------------------------------------------------ train
    def loss(self, batch: Dict[str, torch.Tensor], iteration
             ) -> Dict[str, torch.Tensor]:
        """The BoxInst training losses on one batch.

        batch keys: image (B, 3, H, W) normalised RGB; img_shape (B, 2);
        pixels_removed (B,); gt_bboxes (B, G, 4); gt_labels (B, G);
        gt_valid (B, G). ``iteration`` drives the pairwise warmup."""
        if not self.mask_head.boxinst_enabled:
            raise NotImplementedError('fully supervised CondInst is not '
                                      'copied into the reference')
        feats = self.extract_feat(batch['image'])
        outs, mask_feat = f32_tree(self._forward(feats))
        with fp32_region(mask_feat.device):
            return self._loss(outs, mask_feat, batch, iteration)

    def _loss(self, outs, mask_feat, batch, iteration):
        """The loss math on the heads' fp32 outputs."""
        losses, targets, pts = self.bbox_head.loss(
            outs, batch['gt_bboxes'], batch['gt_labels'], batch['gt_valid'])

        # fixed-capacity positive sampling (reference training_sample,
        # condinst_head.py:1166-1232)
        cls = flatten_levels(outs['cls'])
        ctr = flatten_levels(outs['ctr'])[..., 0]
        score = (torch.sigmoid(cls).amax(-1) * torch.sigmoid(ctr)).detach()
        point_idx, sample_gt, sample_valid = sample_positives_per_gt(
            score, targets.gt_inds, batch['gt_valid'],
            self.mask_head.capacity)

        params_flat = flatten_levels(outs['param'])             # (B, P, Np)
        params = torch.gather(
            params_flat, 1,
            point_idx[..., None].expand(-1, -1, params_flat.shape[-1]))
        coors = pts['points'][point_idx]                        # (B, K, 2)
        levels = pts['level_inds'][point_idx]                   # (B, K)
        mask_logits = self.mask_head.decode(mask_feat, params, coors, levels)
        boxes = torch.gather(batch['gt_bboxes'], 1,
                             sample_gt[..., None].expand(-1, -1, 4))
        sim, _ = self.mask_head.color_similarity_targets(
            batch['image'], self.img_norm_mean, self.img_norm_std,
            batch['img_shape'], batch['pixels_removed'])
        losses.update(self.mask_head.loss(mask_logits, boxes, sample_valid,
                                          sim.detach(), iteration))
        return losses
