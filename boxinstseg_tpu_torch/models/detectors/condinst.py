"""CondInst / BoxInst detector, counterpart of
``boxinstseg_tpu/models/detectors/condinst.py`` (reference:
mmdet/models/detectors/condinst.py): backbone -> FPN -> box head -> mask
branch -> dynamic mask head, and, for fully supervised CondInst, the
semantic head. ``loss`` is the full BoxInst training objective on a
static-shape batch, or with ``mask_head.boxinst_enabled`` False the dice
loss against GT masks (and the semantic loss with a ``segm_head``);
``predict`` emits fixed-capacity
detections and stride-4 mask scores, which ``apis.test.format_detection``
resizes to each image's original resolution.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from ..dense_heads.condinst_head import flatten_levels
from ..layers import f32_tree, fp32_region
from ..losses.dice_loss import dice_coefficient
from ...core.targets.fcos import sample_positives_per_gt
from ...ops.boxes import distance2bbox
from ...ops.nms import greedy_nms, top_k
from ...parallel import dist as pdist
from ...registry import BACKBONES, DETECTORS, HEADS, NECKS
from ...utils.profiling import span

DEFAULT_MEAN = (123.675, 116.28, 103.53)
DEFAULT_STD = (58.395, 57.12, 57.375)


@DETECTORS.register_module()
class CondInst(nn.Module):
    def __init__(self, backbone: dict, neck: Optional[dict] = None,
                 bbox_head: Optional[dict] = None,
                 mask_branch: Optional[dict] = None,
                 mask_head: Optional[dict] = None,
                 segm_head: Optional[dict] = None,
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
        self.segm_head = HEADS.build(segm_head) if segm_head else None
        self.test_cfg = test_cfg
        self.img_norm_mean = tuple(img_norm_mean)
        self.img_norm_std = tuple(img_norm_std)

    def extract_feat(self, images):
        with span('forward.backbone'):
            x = self.backbone(images)
        if self.neck is not None:
            with span('forward.neck'):
                x = self.neck(x)
        return x

    def forward(self, images):
        """Plain forward: box-head outputs (with the dynamic params under
        'param') and the mask-branch features."""
        return self._forward(self.extract_feat(images))

    def _forward(self, feats):
        with span('forward.bbox_head'):
            outs = self.bbox_head(feats)
        with span('forward.mask_head'):
            outs['param'] = [self.mask_head.param_conv(f)
                             for f in outs.pop('reg_feat')]
        with span('forward.mask_branch'):
            return outs, self.mask_branch(feats)

    # ------------------------------------------------------------------ train
    def loss(self, batch: Dict[str, torch.Tensor], iteration
             ) -> Dict[str, torch.Tensor]:
        """The training losses on one batch: BoxInst's, or with
        ``boxinst_enabled`` False CondInst's (dice against ``gt_masks``, and
        the semantic loss with a ``segm_head``).

        batch keys: image (B, 3, H, W) normalised RGB; img_shape (B, 2);
        pixels_removed (B,); gt_bboxes (B, G, 4); gt_labels (B, G);
        gt_valid (B, G); for CondInst gt_masks (B, G, H, W) binary at
        stride 1. ``iteration`` drives the pairwise warmup."""
        feats = self.extract_feat(batch['image'])
        outs, mask_feat = f32_tree(self._forward(feats))
        segm_pred = None
        if self.segm_head is not None and 'gt_masks' in batch:
            with span('forward.segm_head'):
                segm_pred = self.segm_head(feats[0]).float()
        with fp32_region(mask_feat.device), span('loss'):
            losses = self._loss(outs, mask_feat, batch, iteration)
            if segm_pred is not None:
                # the masks are at stride 1 (apis.train.mask_stride)
                losses.update(self.segm_head.loss(
                    segm_pred, batch['gt_masks'], batch['gt_labels'],
                    batch['gt_valid'], mask_stride=1))
            return losses

    def _loss(self, outs, mask_feat, batch, iteration):
        """The loss math on the heads' fp32 outputs."""
        losses, targets, pts = self.bbox_head.loss(
            outs, batch['gt_bboxes'], batch['gt_labels'], batch['gt_valid'])

        with span('loss.mask'):
            # fixed-capacity positive sampling (reference training_sample,
            # condinst_head.py:1166-1232)
            cls = flatten_levels(outs['cls'])
            ctr = flatten_levels(outs['ctr'])[..., 0]
            score = (torch.sigmoid(cls).amax(-1)
                     * torch.sigmoid(ctr)).detach()
            point_idx, sample_gt, sample_valid = sample_positives_per_gt(
                score, targets.gt_inds, batch['gt_valid'],
                self.mask_head.capacity)

            params_flat = flatten_levels(outs['param'])         # (B, P, Np)
            params = torch.gather(
                params_flat, 1,
                point_idx[..., None].expand(-1, -1, params_flat.shape[-1]))
            coors = pts['points'][point_idx]                    # (B, K, 2)
            levels = pts['level_inds'][point_idx]               # (B, K)
            mask_logits = self.mask_head.decode(mask_feat, params, coors,
                                                levels)
            if not self.mask_head.boxinst_enabled:
                losses.update(self.dice_loss(mask_logits, batch['gt_masks'],
                                             sample_gt, sample_valid))
                return losses
            boxes = torch.gather(batch['gt_bboxes'], 1,
                                 sample_gt[..., None].expand(-1, -1, 4))
            sim, _ = self.mask_head.color_similarity_targets(
                batch['image'], self.img_norm_mean, self.img_norm_std,
                batch['img_shape'], batch['pixels_removed'])
            losses.update(self.mask_head.loss(mask_logits, boxes,
                                              sample_valid, sim.detach(),
                                              iteration))
        return losses

    def dice_loss(self, mask_logits, gt_masks, sample_gt, sample_valid):
        """Fully supervised CondInst's mask loss: the dice coefficient of
        each sample's sigmoid mask against its GT mask, sampled at
        ``s//2::s`` for the mask head's ``out_stride`` s from the stride-1
        ``gt_masks``, averaged over the valid samples of the global batch
        (``parallel.dist.reduce_mean_denominator``)."""
        s = self.mask_head.out_stride
        tgt = gt_masks[:, :, s // 2::s, s // 2::s]
        b, k, h, w = mask_logits.shape
        tgt = torch.gather(tgt, 1, sample_gt[..., None, None].expand(
            -1, -1, h, w)).float()
        d = dice_coefficient(torch.sigmoid(mask_logits).reshape(b * k, -1),
                             tgt.reshape(b * k, -1))
        v = sample_valid.reshape(-1).float()
        return dict(loss_mask=(d * v).sum()
                    / pdist.reduce_mean_denominator(v.sum(), 1.0))

    # -------------------------------------------------------------- inference
    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Static-shape detection and mask decode.

        batch keys: image (B, 3, H, W), img_shape (B, 2) and, optionally,
        scale_factor (B, 4), by which the boxes are divided. Returns bboxes
        (B, D, 4), scores (B, D), labels (B, D), valid (B, D) and masks
        (B, D, H/4, W/4): sigmoid scores on the padded canvas, which
        ``format_detection`` crops and rescales. The caller puts the model
        in ``eval()``."""
        outs, mask_feat = f32_tree(self(batch['image']))
        with fp32_region(mask_feat.device), span('postprocess'):
            return self._predict(outs, mask_feat, batch)

    def _predict(self, outs, mask_feat, batch):
        test_cfg = dict(self.test_cfg or {})
        nms_pre = int(test_cfg.get('nms_pre', 1000))
        score_thr = float(test_cfg.get('score_thr', 0.05))
        iou_thr = float(test_cfg.get('nms', {}).get('iou_threshold', 0.5))
        pre_nms_limit = int(test_cfg.get('pre_nms_limit', 1000))
        max_det = int(min(test_cfg.get('max_per_img', 100),
                          test_cfg.get('post_nms_top_k', 100)))

        featmap_sizes = [tuple(x.shape[-2:]) for x in outs['cls']]
        pts = self.bbox_head.points_meta(featmap_sizes, mask_feat.device)
        B = mask_feat.shape[0]
        img_shape = batch['img_shape'].float()[:, None, :]     # (B, 1, 2)

        def take(a, idx):                    # a (B, P[, C]) by idx (B, K)
            if a.dim() == 2:
                return torch.gather(a, 1, idx)
            return torch.gather(a, 1, idx[..., None].expand(
                -1, -1, a.shape[-1]))

        scores, boxes, ctr_s, params, coors, levels = ([] for _ in range(6))
        offset = 0
        for lvl, (h, w) in enumerate(featmap_sizes):
            cls = outs['cls'][lvl].flatten(2).transpose(1, 2)   # (B, hw, C)
            s = torch.sigmoid(cls)
            c = torch.sigmoid(outs['ctr'][lvl].flatten(1))       # (B, hw)
            k = min(nms_pre, h * w)
            _, top = top_k((s * c[..., None]).amax(-1), k)
            points = pts['points'][offset:offset + h * w][top]   # (B, k, 2)
            offset += h * w
            bbox = take(outs['bbox'][lvl].flatten(2).transpose(1, 2), top)
            scores.append(take(s, top))
            boxes.append(distance2bbox(points, bbox, max_shape=img_shape))
            ctr_s.append(take(c, top))
            params.append(take(
                outs['param'][lvl].flatten(2).transpose(1, 2), top))
            coors.append(points)
            levels.append(torch.full((B, k), lvl, dtype=torch.long,
                                     device=mask_feat.device))
        scores, boxes, ctr_s, params, coors, levels = (
            torch.cat(x, 1) for x in (scores, boxes, ctr_s, params, coors,
                                      levels))
        pc, C = scores.shape[1:]

        cand = torch.where(scores > score_thr, scores * ctr_s[..., None],
                           torch.zeros_like(scores))
        cand_scores, cand_idx = top_k(cand.reshape(B, pc * C),
                                      min(pre_nms_limit, pc * C))
        box_idx = cand_idx // C
        cand_labels = (cand_idx % C).int()
        cand_boxes = take(boxes, box_idx)
        keep_idx, keep_valid = greedy_nms(cand_boxes, cand_scores,
                                          cand_labels, iou_thr, max_det)

        det_box_idx = take(box_idx, keep_idx)                    # into Pc
        det_boxes = take(cand_boxes, keep_idx)
        masks = torch.sigmoid(self.mask_head.decode(
            mask_feat, take(params, det_box_idx), take(coors, det_box_idx),
            take(levels, det_box_idx)))                          # (B,D,H4,W4)
        if 'scale_factor' in batch:
            det_boxes = det_boxes / batch['scale_factor'][:, None, :]
        return dict(bboxes=det_boxes,
                    scores=take(cand_scores, keep_idx) * keep_valid,
                    labels=take(cand_labels, keep_idx), valid=keep_valid,
                    masks=masks)
