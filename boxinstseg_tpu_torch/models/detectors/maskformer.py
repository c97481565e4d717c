"""MaskFormer-style detector and the Box2Mask alias, counterpart of
``boxinstseg_tpu/models/detectors/maskformer.py`` (reference:
mmdet/models/detectors/maskformer.py, box2mask.py): backbone -> panoptic
head. ``loss`` is the full Box2Mask training objective on a static-shape
batch. Prediction and the panoptic / instance fusion are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ...registry import BACKBONES, DETECTORS, HEADS, NECKS


@DETECTORS.register_module()
class MaskFormer(nn.Module):
    def __init__(self, backbone: dict, neck: Optional[dict] = None,
                 panoptic_head: Optional[dict] = None,
                 panoptic_fusion_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.backbone = BACKBONES.build(backbone)
        self.neck = NECKS.build(neck) if neck else None
        head_cfg = dict(panoptic_head)
        head_cfg['train_cfg'] = train_cfg
        head_cfg['test_cfg'] = test_cfg
        self.panoptic_head = HEADS.build(head_cfg)
        self.test_cfg = test_cfg

    def extract_feat(self, images):
        x = self.backbone(images)
        if self.neck is not None:
            x = self.neck(x)
        return x

    def forward(self, images):
        return self.panoptic_head(self.extract_feat(images))

    def loss(self, batch: Dict[str, torch.Tensor], iteration=None
             ) -> Dict[str, torch.Tensor]:
        """batch keys: image (B, 3, H, W) normalised RGB; gt_labels (B, G);
        gt_valid (B, G); gt_masks (B, G, H/4, W/4) box bitmasks."""
        outs = self(batch['image'])
        return self.panoptic_head.loss(outs, batch)

    def predict(self, batch):
        raise NotImplementedError(
            'MaskFormer / Box2Mask predict and the fusion post-processing '
            'are not ported yet (ROADMAP Queue 1, slice 3: Box2Mask '
            'predict + COCOeval)')


@DETECTORS.register_module()
class Box2Mask(MaskFormer):
    """Thin alias (reference: box2mask.py:6)."""
