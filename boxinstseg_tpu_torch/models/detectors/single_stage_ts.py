"""DiscoBox teacher-student detector, counterpart of
``boxinstseg_tpu/models/detectors/single_stage_ts.py`` (reference:
mmdet/models/detectors/single_stage_ts.py).

The teacher is an EMA replica of the detector held by the train step
(``engine.train_state.TSTrainStep``); ``avg_loss_ins`` and the gates
it opens are device tensors there, so no step waits on the host for them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..layers import f32_tree, fp32_region
from ...registry import BACKBONES, DETECTORS, HEADS, NECKS
from ...utils.profiling import span


@DETECTORS.register_module()
class SingleStageWSInsDetector(nn.Module):
    """Backbone -> FPN -> SOLO-style head with a unified mask feature head
    (``bbox_head``, ``mask_feat_head``)."""

    def __init__(self, backbone: dict, neck: Optional[dict] = None,
                 bbox_head: Optional[dict] = None,
                 mask_feat_head: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 pretrained: Optional[str] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.backbone = BACKBONES.build(backbone)
        self.neck = NECKS.build(neck) if neck else None
        self.bbox_head = HEADS.build(bbox_head)
        self.mask_feat_head = HEADS.build(mask_feat_head)
        self.mask_feat_levels = (mask_feat_head.get('start_level', 0),
                                 mask_feat_head.get('end_level', 3))
        self.test_cfg = test_cfg

    def extract_feat(self, images):
        with span('forward.backbone'):
            x = self.backbone(images)
        if self.neck is not None:
            with span('forward.neck'):
                x = self.neck(x)
        return x

    def _mask_feat_inputs(self, feats):
        s, e = self.mask_feat_levels
        return feats[s:e + 1]

    def forward(self, images):
        """Raw head outputs (kernels, cates) and the unified mask feature."""
        return self._heads(self.extract_feat(images))

    def _heads(self, feats, **kwargs):
        """The head's raw outputs and the unified mask feature."""
        with span('forward.bbox_head'):
            outs = self.bbox_head(feats, **kwargs)
        with span('forward.mask_feat_head'):
            return outs, self.mask_feat_head(self._mask_feat_inputs(feats))

    @torch.no_grad()
    def teacher_outputs(self, images) -> Dict[str, torch.Tensor]:
        """Raw kernels, the mask feature and P2, for the EMA replica
        (reference teacher forward, single_stage_ts.py:195-199)."""
        feats = self.extract_feat(images)
        outs, mask_feat = self._heads(feats)
        return dict(kernels=outs['kernels'], mask_feat=mask_feat,
                    p2=feats[0])

    def loss(self, batch: Dict[str, torch.Tensor], iteration=None,
             teacher_out: Optional[Dict] = None,
             gates: Optional[Dict] = None, bank=None
             ) -> Dict[str, torch.Tensor]:
        """DiscoBox losses. ``teacher_out`` (from ``teacher_outputs`` of the
        replica) stands for the teacher when given; without it the detached
        student does, which gives the JAX package's values (its teacher gate
        is a traced 0/1 blend; here the train step decides on the host).
        ``gates['ts']`` and ``gates['corr']`` multiply the CRF and
        correspondence terms. A ``'_corr_append'`` entry, when present,
        holds the bank's append entries and is no loss."""
        feats = self.extract_feat(batch['image'])
        outs, mask_feat = self._heads(feats)
        outs, mask_feat = f32_tree(outs), mask_feat.float()
        feats = f32_tree(feats)       # P2 feeds the correspondence loss
        teacher_out = f32_tree(teacher_out)
        gates = gates or {}
        with fp32_region(mask_feat.device), span('loss'):
            return self.bbox_head.loss(
                outs, mask_feat, batch, teacher=teacher_out,
                use_ts_gate=gates.get('ts'), corr_gate=gates.get('corr'),
                bank=bank, s_feat=feats[0],
                t_feat=None if teacher_out is None else teacher_out['p2'])

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """batch['image'] (B, 3, H, W) -> the head's ``get_seg``: scores,
        labels, valid (B, D) and masks (B, D, H/4, W/4) sigmoid scores on
        the padded canvas. Under the bf16 policy the selection and the
        matrix NMS run in fp32 (its mask products count pixels). The
        caller puts the model in ``eval()``."""
        outs, mask_feat = self._heads(self.extract_feat(batch['image']),
                                      train=False)
        outs, mask_feat = f32_tree(outs), mask_feat.float()
        with fp32_region(mask_feat.device), span('postprocess'):
            return self.bbox_head.get_seg(outs, mask_feat, self.test_cfg)


@DETECTORS.register_module()
class SingleStageWSInsTSDetector(SingleStageWSInsDetector):
    """Teacher-student variant; the EMA replica is the train step's."""


@DETECTORS.register_module()
class DiscoBoxSOLOv2(SingleStageWSInsTSDetector):
    """Thin alias (reference: discobox.py:16)."""
