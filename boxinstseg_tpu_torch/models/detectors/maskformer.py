"""MaskFormer-style detector, the Box2Mask alias and the fusion
post-processing, counterpart of
``boxinstseg_tpu/models/detectors/maskformer.py`` (reference:
mmdet/models/detectors/maskformer.py, box2mask.py and
maskformer_fusion_head.py): backbone -> panoptic head. ``loss`` is the full
Box2Mask training objective on a static-shape batch; ``predict`` is the
device half of inference (fixed-capacity instance candidates with their
mask logits; binarising, rescoring and COCO formatting happen on the host
at the original resolution and are not ported yet).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ...registry import BACKBONES, DETECTORS, HEADS, NECKS

# reference: mmdet/core/evaluation/panoptic_utils.py:6 —
# pan_id = cat_id + ins_id * INSTANCE_OFFSET
INSTANCE_OFFSET = 1000


def panoptic_postprocess(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                         num_things_classes: int = 80,
                         num_stuff_classes: int = 53,
                         object_mask_thr: float = 0.8,
                         iou_thr: float = 0.8,
                         filter_low_score: bool = False) -> torch.Tensor:
    """Panoptic fusion for ONE image (reference MaskFormerFusionHead.
    panoptic_postprocess), vectorised as the JAX package does it: each
    pixel goes to the kept query with the highest score-weighted mask
    probability; instance ids count the valid things in query order.

    mask_cls: (Q, C+1) logits incl. background; mask_pred: (Q, H, W)
    logits. Returns an (H, W) int32 map of ``label + instance_id *
    INSTANCE_OFFSET`` for things, ``label`` for stuff and ``num_classes``
    for void.
    """
    num_classes = num_things_classes + num_stuff_classes
    probs = torch.softmax(mask_cls.float(), dim=-1)
    scores, labels = probs.max(dim=-1)
    masks = torch.sigmoid(mask_pred.float())                 # (Q, H, W)
    keep = (labels != num_classes) & (scores > object_mask_thr)
    # non-kept queries are pinned to -1 and never win; a pixel no kept
    # query covers falls to query 0, which the validity gate maps to void
    prob_masks = torch.where(keep[:, None, None],
                             scores[:, None, None] * masks,
                             torch.full_like(masks, -1.0))
    winner = prob_masks.argmax(dim=0)                        # (H, W)
    q = mask_cls.shape[0]
    mask_area = torch.bincount(winner.reshape(-1), minlength=q).float()
    original_area = (masks >= 0.5).sum(dim=(1, 2)).float()
    valid = (keep & (mask_area > 0) & (original_area > 0)
             & (mask_area >= iou_thr * original_area))
    is_thing = labels < num_things_classes
    inst_id = torch.cumsum((valid & is_thing).int(), 0)
    seg_val = torch.where(is_thing, labels + inst_id * INSTANCE_OFFSET,
                          labels)
    seg_val = torch.where(valid, seg_val, torch.full_like(seg_val,
                                                          num_classes))
    pan = seg_val[winner].int()
    if filter_low_score:
        win_prob = torch.gather(masks, 0, winner[None])[0]
        pan = torch.where(win_prob >= 0.5, pan,
                          torch.full_like(pan, num_classes))
    return pan


def semantic_postprocess(mask_cls: torch.Tensor, mask_pred: torch.Tensor):
    """The reference's semantic path is itself unimplemented
    (maskformer_fusion_head.py:94-110 raises)."""
    raise NotImplementedError(
        'semantic segmentation results are not supported yet '
        '(matches reference maskformer_fusion_head.py:110)')


def instance_postprocess(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                         max_per_image: int = 100) -> Dict[str, torch.Tensor]:
    """Query outputs -> fixed-capacity instance candidates: the flattened
    (query, class) top-k of the softmax scores without the background
    class, and the matching mask LOGITS.

    mask_cls: (B, Q, C+1); mask_pred: (B, Q, H4, W4) logits.
    """
    b, q, cp1 = mask_cls.shape
    c = cp1 - 1
    scores = torch.softmax(mask_cls, dim=-1)[..., :-1]        # (B, Q, C)
    k = min(max_per_image, q * c)
    top_scores, top_idx = scores.reshape(b, q * c).topk(k, dim=1)
    labels = (top_idx % c).int()
    query_idx = top_idx // c
    masks_logit = torch.gather(
        mask_pred, 1, query_idx[..., None, None].expand(
            -1, -1, *mask_pred.shape[2:]))                   # (B, k, H, W)
    return dict(scores=top_scores, labels=labels, masks_logit=masks_logit,
                valid=torch.ones_like(top_scores, dtype=torch.bool))


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

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """batch['image'] (B, 3, H, W) normalised RGB -> the instance
        candidates of ``instance_postprocess`` from the last decoder
        output; with ``test_cfg.panoptic_on`` also its raw class and mask
        logits (``pan_cls``, ``pan_masks_logit``) for the host-side fusion
        at the original resolution. The caller puts the model in
        ``eval()``."""
        outs = self(batch['image'])
        test_cfg = dict(self.test_cfg or {})
        out = instance_postprocess(outs['cls'][-1], outs['masks'][-1],
                                   int(test_cfg.get('max_per_image', 100)))
        if test_cfg.get('panoptic_on', False):
            out['pan_cls'] = outs['cls'][-1]
            out['pan_masks_logit'] = outs['masks'][-1]
        return out


@DETECTORS.register_module()
class Box2Mask(MaskFormer):
    """Thin alias (reference: box2mask.py:6)."""
