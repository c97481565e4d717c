"""SOLO-style box-supervised detectors, counterpart of
``boxinstseg_tpu/models/detectors/single_stage_boxseg.py`` (reference:
mmdet/models/detectors/single_stage_boxseg.py and boxlevelset.py).

``predict`` returns the head's fixed-capacity stride-4 mask scores; the
boxes come from the mask extents in ``apis.test.format_detection``, as the
reference's ``format_results`` derives them (single_stage_boxseg.py:75-90).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..layers import f32_tree, fp32_region
from ...registry import BACKBONES, DETECTORS, HEADS, NECKS
from ...utils.profiling import span


@DETECTORS.register_module()
class SingleStageBoxInsDetector(nn.Module):
    """Backbone -> FPN -> a SOLO-style head that holds its own mask
    feature (``bbox_head``, such as ``BoxSOLOv2Head``)."""

    def __init__(self, backbone: dict, neck: Optional[dict] = None,
                 bbox_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.backbone = BACKBONES.build(backbone)
        self.neck = NECKS.build(neck) if neck else None
        self.bbox_head = HEADS.build(bbox_head)
        self.test_cfg = test_cfg

    def extract_feat(self, images):
        with span('forward.backbone'):
            x = self.backbone(images)
        if self.neck is not None:
            with span('forward.neck'):
                x = self.neck(x)
        return x

    def forward(self, images, train: bool = True):
        """The head's raw outputs (logits with ``train``)."""
        feats = self.extract_feat(images)
        with span('forward.bbox_head'):
            return self.bbox_head(feats, train=train)

    def loss(self, batch: Dict[str, torch.Tensor], iteration=None
             ) -> Dict[str, torch.Tensor]:
        """The head's losses, its outputs in fp32 (the bf16 policy's loss
        boundary)."""
        outs = f32_tree(self(batch['image']))
        with fp32_region(outs['mask_feat'].device), span('loss'):
            return self.bbox_head.loss(outs, batch)

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """batch['image'] (B, 3, H, W) -> the head's ``get_seg``: scores,
        labels, valid (B, D) and masks (B, D, H/4, W/4) sigmoid scores on
        the padded canvas, the selection in fp32 under the bf16 policy.
        The caller puts the model in ``eval()``."""
        outs = f32_tree(self(batch['image'], train=False))
        with fp32_region(outs['mask_feat'].device), span('postprocess'):
            return self.bbox_head.get_seg(outs, self.test_cfg)


@DETECTORS.register_module()
class BoxLevelSet(SingleStageBoxInsDetector):
    """Thin alias (reference: boxlevelset.py:5)."""
