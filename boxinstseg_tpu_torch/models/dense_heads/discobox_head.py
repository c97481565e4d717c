"""DiscoBox SOLOv2 head, mask feature head and mean-field CRF (NCHW),
counterpart of ``boxinstseg_tpu/models/dense_heads/discobox_head.py``
(reference: mmdet/models/dense_heads/discobox_head.py).

- Grid kernels and categories through interpolate-then-conv branches; the
  masks of the sampled cells are one batched product of kernels and the
  unified mask feature.
- MIL projection loss (row and column max dice).
- Mean-field CRF pseudo-labels under no-grad: the binary fixed point is
  ``ops.crf`` (the K7 kernel on a card); the variant with inter-image
  priors, which the JAX package runs in plain XLA, stays plain PyTorch.
- Cross-image correspondence with the object bank (``ops.correspondence``)
  when the config has ``loss_corr``.

Module and parameter names follow the mmdet reference (``kernel_convs.i``,
``cate_convs.i``, ``solo_cate``, ``solo_kernel``, ``convs_all_levels.i.
convj``, ``conv_pred.0``). The teacher and the ``avg_loss_ins`` gates live in
the detector and the train step.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d, ConvModule, bias_init_with_prob, normal_init_
from .solo_common import coord_feat, decode_masks, solo_get_seg
from ...core.targets.solo import sample_positive_cells, solo_targets
from ...ops.correspondence import (bank_retrieve_batch, info_nce_loss,
                                   relu_l2_norm, solve_correspondence)
from ...ops.crf import crf_mean_field, kernel_sum, stencil_sum
from ...ops.nms import points_nms_2x2
from ...ops.roi_align import roi_align
from ...ops.upsample import interpolate_bilinear
from ...parallel import dist as pdist
from ...registry import HEADS, LOSSES


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """value[p] = x[p + (dy, dx)] on the last two axes, zero outside."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    return xp[..., max(dy, 0):max(dy, 0) + h, max(dx, 0):max(dx, 0) + w]


def _paste_roi(ci: torch.Tensor, box: torch.Tensor, h: int, w: int
               ) -> torch.Tensor:
    """Paste (..., 2, mh, mw) ROI maps into (..., 2, h, w) canvases over
    ``box`` (..., 4) (xyxy, grid coordinates) by inverse-ROI bilinear
    sampling (reference: the dynamic-slice paste, discobox_head.py:
    1104-1108)."""
    lead = ci.shape[:-3]
    mh, mw = ci.shape[-2:]
    ci = ci.reshape((-1,) + tuple(ci.shape[-3:]))
    box = box.reshape(-1, 4)
    n = ci.shape[0]
    ys = torch.arange(h, dtype=torch.float32, device=ci.device)
    xs = torch.arange(w, dtype=torch.float32, device=ci.device)
    bw = torch.clamp(box[:, 2] - box[:, 0], min=1e-3)
    bh = torch.clamp(box[:, 3] - box[:, 1], min=1e-3)
    u = (xs[None] - box[:, 0:1]) / bw[:, None] * mw - 0.5          # (n, w)
    v = (ys[None] - box[:, 1:2]) / bh[:, None] * mh - 0.5          # (n, h)
    inside = ((xs[None] >= box[:, 0:1]) & (xs[None] < box[:, 2:3]))[
        :, None, :] & ((ys[None] >= box[:, 1:2])
                       & (ys[None] < box[:, 3:4]))[:, :, None]
    v0 = torch.floor(v)
    u0 = torch.floor(u)
    fv = (v - v0)[:, None, :, None]
    fu = (u - u0)[:, None, None, :]
    rows = torch.arange(n, device=ci.device)[:, None, None]

    def g(yy, xx):
        yi = torch.clamp(yy, 0, mh - 1).long()
        xi = torch.clamp(xx, 0, mw - 1).long()
        return ci[rows, :, yi[:, :, None], xi[:, None, :]].permute(0, 3, 1, 2)

    out = ((1 - fv) * ((1 - fu) * g(v0, u0) + fu * g(v0, u0 + 1))
           + fv * ((1 - fu) * g(v0 + 1, u0) + fu * g(v0 + 1, u0 + 1)))
    out = out * inside[:, None].to(out.dtype)
    return out.reshape(tuple(lead) + (2, h, w))


def dice_loss_eps(x: torch.Tensor, t: torch.Tensor, eps: float = 1e-3
                  ) -> torch.Tensor:
    """Per-instance dice with the reference's 0.001 smoothing."""
    n = x.shape[0]
    x = x.reshape(n, -1)
    t = t.reshape(n, -1)
    a = (x * t).sum(1)
    b = (x * x).sum(1) + eps
    c = (t * t).sum(1) + eps
    return 1.0 - 2.0 * a / (b + c)


def mil_projection_loss(scores: torch.Tensor, target: torch.Tensor
                        ) -> torch.Tensor:
    """Row and column max-projection dice (reference mil_loss,
    discobox_head.py:552-562). scores, target (N, H, W). ``amax`` splits the
    gradient evenly among tied maxima, as JAX's ``max`` does."""
    row = dice_loss_eps(scores.amax(dim=1), target.amax(dim=1))
    col = dice_loss_eps(scores.amax(dim=2), target.amax(dim=2))
    return row + col


class MeanFieldCRF:
    """Fixed-iteration mean-field refinement producing pseudo-labels
    (reference MeanField, discobox_head.py:585-651), under no-grad.

    The state is re-binarised every round, so without inter-image priors
    the exp / compare update reduces to ``targets AND s > kv / 2`` (the JAX
    package's derivation): the K7 fixed point of ``ops.crf``. With priors
    the exp form runs as plain PyTorch, as the JAX package runs it in
    XLA."""

    def __init__(self, kernel_size=3, theta0=0.5, theta1=30.0, theta2=20.0,
                 alpha0=2.0, base=0.10, num_iter=10, gamma=0.01):
        self.kernel_size = kernel_size
        self.theta0 = theta0
        self.theta1 = theta1
        self.alpha0 = alpha0
        self.base = base
        self.num_iter = num_iter
        self.gamma = gamma
        half = kernel_size // 2
        self.offsets = [(dy, dx) for dy in range(-half, half + 1)
                        for dx in range(-half, half + 1)]

    @torch.no_grad()
    def build_kernel(self, color_feat: torch.Tensor) -> torch.Tensor:
        """color_feat (B, 3, H, W), the image at mask resolution. Returns
        the (B, O, H, W) appearance and spatial kernel (the reference adds 10
        to the image first, so a neighbour outside differs by 10 a channel,
        as its zero-padded unfold does)."""
        feat = color_feat + 10.0
        ks = []
        for dy, dx in self.offsets:
            diff2 = ((_shift2d(feat, dy, dx) - feat) ** 2).sum(dim=1)
            spatial = float(dy * dy + dx * dx)
            ks.append(self.alpha0 * torch.exp(
                -diff2 / (2 * self.theta0 ** 2)
                - spatial / (2 * self.theta1 ** 2)))
        return torch.stack(ks, dim=1)

    @torch.no_grad()
    def __call__(self, kernel: torch.Tensor, x: torch.Tensor,
                 targets: torch.Tensor,
                 iiu: Optional[torch.Tensor] = None) -> torch.Tensor:
        """kernel (B, O, H, W); x (B, K, H, W) mask scores; targets
        (B, K, H, W) box masks; iiu optional (B, K, 2, H, W) inter-image
        priors. Returns binary pseudo-labels (B, K, H, W)."""
        x = x * targets
        kv = kernel_sum(kernel, self.offsets)
        bin0 = (x > 0.5).to(torch.float32)
        if iiu is None:
            return crf_mean_field(kernel.contiguous(), 0.5 * kv, bin0,
                                  targets.contiguous(), self.num_iter,
                                  self.kernel_size)
        a_c = -float(np.log(self.base))
        b_c = float(np.log(self.base) - np.log(1.0 - self.base))
        kv = kv[:, None]
        st = bin0
        for _ in range(self.num_iter):
            s = stencil_sum(st, kernel)
            f_fg = torch.exp(-(a_c * kv + b_c * s)) + iiu[:, :, 1] * self.gamma
            f_bg = torch.exp(-((a_c + b_c) * kv - b_c * s)) \
                + iiu[:, :, 0] * self.gamma
            fg = f_fg * targets + 1e-6
            bg = f_bg + 1e-6
            st = (fg / (fg + bg) > 0.5).to(torch.float32)
        return st


@HEADS.register_module()
class DiscoBoxMaskFeatHead(nn.Module):
    """Unified stride-4 mask feature (reference DiscoBoxMaskFeatHead,
    discobox_head.py:415-520): per-level conv (+2x upsample) chains summed,
    coordinate channels on level 3, a 1x1 GN conv at the end."""

    def __init__(self, in_channels: int = 256, out_channels: int = 128,
                 start_level: int = 0, end_level: int = 3,
                 num_classes: int = 256, conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        norm = norm_cfg or dict(type='GN', num_groups=32)
        self.convs_all_levels = nn.ModuleList()
        for i in range(end_level - start_level + 1):
            level = nn.Module()
            for j in range(max(i, 1)):
                cin = out_channels if j else in_channels + (2 if i == 3
                                                            else 0)
                level.add_module(f'conv{j}', ConvModule(
                    cin, out_channels, 3, 1, 1, norm_cfg=norm,
                    init_std=0.01))
            self.convs_all_levels.append(level)
        self.conv_pred = nn.Sequential(ConvModule(
            out_channels, num_classes, 1, 1, 0, norm_cfg=norm,
            init_std=0.01))

    def forward(self, feats):
        b = feats[0].shape[0]
        target_hw = tuple(feats[0].shape[-2:])
        out = None
        for i, level in enumerate(self.convs_all_levels):
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
            out = x if out is None else out + x
        return self.conv_pred(out)


@HEADS.register_module()
class DiscoBoxSOLOv2Head(nn.Module):
    """Grid category and kernel branches (reference DiscoBoxSOLOv2Head,
    discobox_head.py:656-857), the DiscoBox losses, the correspondence
    terms and the prediction path (points NMS, then matrix NMS in
    ``get_seg``)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 seg_feat_channels: int = 512, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 8, 16, 32, 32),
                 base_edge_list: Sequence[int] = (16, 32, 64, 128, 256),
                 scale_ranges: Sequence = ((1, 96), (48, 192), (96, 384),
                                           (192, 768), (384, 2048)),
                 sigma: float = 0.2,
                 num_grids: Sequence[int] = (40, 36, 24, 16, 12),
                 ins_out_channels: int = 256,
                 loss_ins: Optional[dict] = None,
                 loss_ts: Optional[dict] = None,
                 loss_cate: Optional[dict] = None,
                 loss_corr: Optional[dict] = None,
                 conv_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 use_dcn_in_tower: bool = False,
                 type_dcn: Optional[str] = None,
                 init_cfg: Optional[dict] = None, max_pos: int = 128,
                 max_corr_queries: int = 16):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.scale_ranges = tuple(tuple(r) for r in scale_ranges)
        self.sigma = sigma
        self.num_grids = tuple(num_grids)
        self.loss_ins = loss_ins
        self.loss_ts = loss_ts
        self.loss_cate = loss_cate
        self.loss_corr = loss_corr
        self.max_pos = max_pos
        self.max_corr_queries = max_corr_queries
        gn = dict(type='GN', num_groups=min(32, seg_feat_channels))
        dcn = type_dcn if use_dcn_in_tower else None   # deformable towers

        def tower(first_in):
            return nn.ModuleList(ConvModule(
                first_in if i == 0 else seg_feat_channels,
                seg_feat_channels, 3, 1, 1, norm_cfg=gn, bias=False,
                init_std=0.01, conv_type=dcn) for i in range(stacked_convs))

        self.kernel_convs = tower(in_channels + 2)
        self.cate_convs = tower(in_channels)
        self.solo_cate = normal_init_(
            Conv2d(seg_feat_channels, num_classes, 3, 1, 1), 0.01,
            bias_init_with_prob(0.01))
        self.solo_kernel = normal_init_(
            Conv2d(seg_feat_channels, ins_out_channels, 3, 1, 1), 0.01)

    @property
    def corr_cfg(self) -> Dict:
        return dict(self.loss_corr or {})

    @property
    def obj_bank_cfg(self) -> Dict:
        return dict(self.corr_cfg.get('obj_bank', {}))

    def forward(self, feats, train: bool = True
                ) -> Dict[str, torch.Tensor]:
        """Kernels (B, Pc, E) and cates (B, Pc, C), cells level-major. With
        ``train`` the cates are logits; without it they are sigmoid scores
        after the points NMS, the prediction outputs."""
        b = feats[0].shape[0]
        p2h, p2w = feats[0].shape[-2:]
        new_feats = [interpolate_bilinear(feats[0], (p2h // 2, p2w // 2)),
                     feats[1], feats[2], feats[3],
                     interpolate_bilinear(feats[4], feats[3].shape[-2:])]
        kernels, cates = [], []
        for x, s in zip(new_feats, self.num_grids):
            coord = coord_feat(b, x.shape[2], x.shape[3], x.device)
            # the coordinate-augmented feature goes to the grid first
            # (reference forward_single, discobox_head.py:817-833)
            kfeat = interpolate_bilinear(torch.cat([x, coord], dim=1),
                                         (s, s))
            cfeat = kfeat[:, :-2]
            for kconv, cconv in zip(self.kernel_convs, self.cate_convs):
                kfeat = kconv(kfeat)
                cfeat = cconv(cfeat)
            cate = self.solo_cate(cfeat)
            if not train:
                # fp32 under the bf16 policy, as the selection after it
                cate = points_nms_2x2(torch.sigmoid(cate.float()))
            kernels.append(self.solo_kernel(kfeat).flatten(2).transpose(1, 2))
            cates.append(cate.flatten(2).transpose(1, 2))
        return dict(kernels=torch.cat(kernels, dim=1),
                    cates=torch.cat(cates, dim=1))

    decode_masks = staticmethod(decode_masks)

    # ---------------------------------------------------- correspondence
    @staticmethod
    def _mask_boxes(box_mask: torch.Tensor) -> torch.Tensor:
        """(B, K, H, W) -> (B, K, 4) tight xyxy extents in grid coordinates
        (first and last set row and column; an empty mask gives
        (0, 0, W, H))."""
        rows = (box_mask.amax(dim=3) > 0).to(torch.uint8)
        cols = (box_mask.amax(dim=2) > 0).to(torch.uint8)
        h, w = rows.shape[-1], cols.shape[-1]
        min_y = torch.argmax(rows, dim=-1)
        max_y = h - torch.argmax(rows.flip(-1), dim=-1)
        min_x = torch.argmax(cols, dim=-1)
        max_x = w - torch.argmax(cols.flip(-1), dim=-1)
        return torch.stack([min_x, min_y, max_x, max_y], -1).float()

    def _corr_terms(self, bank, s_scores, t_scores, box_mask, labels_k,
                    valid_k, s_feat, t_feat, corr_gate):
        """Cross-image correspondence loss, inter-image (iiu) CRF priors and
        the bank's append entries (reference corr_loss, discobox_head.py:
        900-1139). s_feat and t_feat are (B, C, H4, W4)."""
        cfg = self.corr_cfg
        ob = self.obj_bank_cfg
        fh, fw = ob.get('feat_height', 7), ob.get('feat_width', 7)
        mh, mw = ob.get('mask_height', 28), ob.get('mask_width', 28)
        min_size = ob.get('min_size', 32)
        b, k, h4, w4 = s_scores.shape
        q = self.max_corr_queries
        dev = s_scores.device

        boxes = self._mask_boxes(box_mask)
        # the first Q valid instances across the batch; under a process
        # group, across the global batch: this rank's valid ones come after
        # ``before`` valid ones of the lower ranks, and only those within
        # the first Q are queries (``q_take``; an invalid slot is inert)
        flat_valid = valid_k.reshape(-1)
        idx = torch.arange(b * k, device=dev)
        order = torch.argsort(torch.where(flat_valid, idx, b * k + idx))[:q]
        counts = pdist.all_gather_fixed(flat_valid.sum())
        before = counts[:pdist.rank()].sum()
        q_take = before + torch.arange(order.shape[0], device=dev) < q
        q_valid = flat_valid[order] & q_take
        q_boxes = boxes.reshape(-1, 4)[order]
        q_labels = labels_k.reshape(-1)[order]

        rois_feat = torch.cat([(order // k).float()[:, None], q_boxes], 1)
        q_feat = relu_l2_norm(roi_align(s_feat, rois_feat, (fh, fw))
                              .permute(0, 2, 3, 1), dim=-1)
        t_src = t_feat if t_feat is not None else s_feat
        qt_feat = relu_l2_norm(roi_align(t_src.detach(), rois_feat, (fh, fw))
                               .permute(0, 2, 3, 1), dim=-1)
        rois_mask = torch.cat([order.float()[:, None], q_boxes], 1)
        q_mask = roi_align(s_scores.detach().reshape(b * k, 1, h4, w4),
                           rois_mask, (mh, mw))[:, 0]
        qt_mask = roi_align(t_scores.detach().reshape(b * k, 1, h4, w4),
                            rois_mask, (mh, mw))[:, 0]

        kf, km, pair_valid = bank_retrieve_batch(
            bank, q_labels, q_feat.detach(), q_mask, q_boxes,
            fg_iou_thresh=ob.get('fg_iou_thresh', 0.7),
            bg_iou_thresh=ob.get('bg_iou_thresh', 0.7),
            appear_thresh=ob.get('appear_thresh', 0.7),
            ratio_range=tuple(ob.get('ratio_range', (0.9, 1.2))),
            max_retrieval=ob.get('max_retrieval_objs', 5))
        r = kf.shape[1]
        q_ok = q_valid & (pair_valid.sum(-1) >= min(5, r))

        # regularised Hough matching of each query against its R keys
        n = fh * fw
        qcells = q_feat.reshape(q, 1, n, -1).expand(q, r, n, q_feat.shape[-1])
        cu, t_assign = solve_correspondence(
            qcells.reshape(q * r, n, -1), kf.reshape(q * r, n, -1), (fh, fw),
            num_iter=cfg.get('corr_num_iter', 10),
            num_smooth_iter=cfg.get('corr_num_smooth_iter', 1),
            dist_kernel=cfg.get('dist_kernel', 9))
        cu = cu.reshape(q, r, n, n)
        t_assign = t_assign.reshape(q, r, n, n)
        # reference quirk: the cross-entropy gets the already-softmaxed Cu
        # as its logits (discobox_head.py:1083-1086)
        per_q = info_nce_loss(F.softmax(cu, dim=-1), t_assign, pair_valid)
        okf = q_ok.float()
        loss_corr = (per_q * okf).sum() \
            / pdist.reduce_mean_denominator(okf.sum(), 1e-4)
        loss_corr = loss_corr * cfg.get('loss_weight', 1.0) * corr_gate

        # inter-image priors of the Q queries, all queries at once
        # ((Q, R, 784, 784) maps, ~200 MB at Q = 16, R = 5)
        with torch.no_grad():
            nmask = mh * mw
            t_q = t_assign * F.softmax(cu, dim=3)
            t_q = t_q / (t_q.sum(3, keepdim=True) + 1e-5)
            tq = interpolate_bilinear(t_q.reshape(q * r * n, fh, fw),
                                      (mh, mw)).reshape(q, r, n, nmask)
            tq = tq.transpose(2, 3).reshape(q * r * nmask, fh, fw)
            tq = interpolate_bilinear(tq, (mh, mw)).reshape(q, r, nmask,
                                                            nmask)
            tq = tq.transpose(2, 3) * (n / nmask)
            qm = q_mask.reshape(q, 1, nmask, 1)
            kmf = km.reshape(q, r, 1, nmask)
            fg_pair = (qm * kmf) > 0.5
            bg_pair = ((1 - qm) * (1 - kmf)) > 0.5
            pvf = pair_valid.float()
            denom_r = torch.clamp(pvf.sum(-1), min=1e-4)[:, None]
            kmf = kmf[:, :, 0]
            fg_ci = torch.einsum('qrnm,qrm->qn', tq * fg_pair,
                                 torch.clamp(kmf, 0.1, 0.9)
                                 * pvf[..., None]) / denom_r
            bg_ci = torch.einsum('qrnm,qrm->qn', tq * bg_pair,
                                 torch.clamp(1 - kmf, 0.1, 0.9)
                                 * pvf[..., None]) / denom_r
            ci = torch.stack([bg_ci, fg_ci], 1).reshape(q, 2, mh, mw)
            canvases = _paste_roi(ci, q_boxes, h4, w4)
            # only the Q query slots carry priors; the consumer runs the
            # exp-form CRF on these rows alone
            iiu = dict(rows=canvases * okf[:, None, None, None] * corr_gate,
                       order=order, take=q_take)

        wide = (q_boxes[:, 2] - q_boxes[:, 0]) > min_size
        tall = (q_boxes[:, 3] - q_boxes[:, 1]) > min_size
        append = dict(labels=q_labels, feats=qt_feat.detach(),
                      masks=qt_mask, boxes=q_boxes,
                      valid=q_valid & wide & tall & (corr_gate > 0))
        return loss_corr, iiu, append

    # ------------------------------------------------------------------ loss
    def loss(self, outs: Dict, mask_feat: torch.Tensor,
             batch: Dict[str, torch.Tensor], teacher: Optional[Dict] = None,
             use_ts_gate=None, corr_gate=None, bank=None, s_feat=None,
             t_feat=None) -> Dict[str, torch.Tensor]:
        """Student losses. ``teacher`` carries the EMA replica's kernels and
        mask feature (no grad). ``use_ts_gate`` and ``corr_gate`` are 0/1
        device tensors; the CRF and correspondence terms are always computed
        and multiplied by them, as in the JAX package. batch: image
        (B, 3, H, W), gt_bboxes, gt_labels, gt_valid, gt_masks (B, G, H/4,
        W/4)."""
        loss_cate_fn = LOSSES.build(self.loss_cate or dict(
            type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
            loss_weight=1.0))
        ins_w = (self.loss_ins or {}).get('loss_weight', 1.0)
        ts_cfg = dict(self.loss_ts or {})
        ts_w = ts_cfg.get('loss_weight', 1.0)

        img = batch['image']
        bsz, _, hh, ww = img.shape
        targets = solo_targets(
            batch['gt_bboxes'], batch['gt_labels'], batch['gt_valid'],
            batch['gt_masks'], (hh, ww), self.num_grids, self.scale_ranges,
            self.sigma, self.num_classes, mask_stride=4, min_mask_area=1.0)
        loss_cate = loss_cate_fn(outs['cates'], targets.cate_labels,
                                 avg_factor=pdist.reduce_mean_denominator(
                                     targets.num_pos.float(), offset=1.0))

        cell_idx, gt_idx, valid = sample_positive_cells(targets.cell_gt,
                                                        self.max_pos)
        vmask = valid.float().reshape(-1)
        denom = pdist.reduce_mean_denominator(vmask.sum(), 1.0)

        e = outs['kernels'].shape[-1]
        s_kernels = torch.gather(outs['kernels'], 1,
                                 cell_idx[..., None].expand(-1, -1, e))
        s_scores = torch.sigmoid(self.decode_masks(mask_feat, s_kernels))
        k = s_scores.shape[1]
        h4, w4 = s_scores.shape[2:]
        box_mask = torch.gather(
            batch['gt_masks'].float(), 1,
            gt_idx[:, :, None, None].expand(-1, -1, h4, w4))

        mil = mil_projection_loss(s_scores.reshape(bsz * k, h4, w4),
                                  box_mask.reshape(bsz * k, h4, w4))
        loss_ins = ins_w * (mil * vmask).sum() / denom

        if teacher is not None:
            t_kernels = torch.gather(teacher['kernels'], 1,
                                     cell_idx[..., None].expand(-1, -1, e))
            t_scores = torch.sigmoid(self.decode_masks(
                teacher['mask_feat'], t_kernels)).detach()
        else:
            t_scores = s_scores

        cg = corr_gate if corr_gate is not None else torch.zeros(
            (), device=img.device)
        corr = None
        if bank is not None and self.loss_corr is not None \
                and s_feat is not None:
            labels_k = torch.gather(batch['gt_labels'].long(), 1, gt_idx)
            corr = self._corr_terms(bank, s_scores, t_scores, box_mask,
                                    labels_k, valid, s_feat, t_feat, cg)

        crf = MeanFieldCRF(
            kernel_size=ts_cfg.get('kernel', 3),
            theta0=ts_cfg.get('theta0', 0.5),
            theta1=ts_cfg.get('theta1', 30.0),
            theta2=ts_cfg.get('theta2', 20.0),
            alpha0=ts_cfg.get('alpha0', 2.0),
            base=ts_cfg.get('base', 0.10),
            num_iter=ts_cfg.get('max_iter', 10))
        color = interpolate_bilinear(img.detach(), (h4, w4),
                                     align_corners=True)
        kernel = crf.build_kernel(color)
        avg_scores = (s_scores + t_scores) / 2.0
        pseudo = crf(kernel, avg_scores, box_mask)
        # the enlarged target: a 3x3 dilation of the box mask
        enlarged = F.max_pool2d(box_mask, 3, 1, 1)
        s_flat = (s_scores * enlarged).reshape(bsz * k, -1)
        ts = dice_loss_eps(s_flat, pseudo.reshape(bsz * k, -1))
        loss_ts = (ts * vmask).sum() / denom
        if corr is not None:
            iiu = corr[1]
            # the exp-form CRF on the Q query rows only (every other slot
            # has no prior, where it gives the plain CRF's ``pseudo``), its
            # rows written back over the plain result
            order_q = iiu['order']
            xq = avg_scores.reshape(bsz * k, h4, w4)[order_q][:, None]
            tq = box_mask.reshape(bsz * k, h4, w4)[order_q][:, None]
            pq = crf(kernel[order_q // k], xq, tq,
                     iiu=iiu['rows'][:, None])[:, 0]
            pseudo_iiu = pseudo.reshape(bsz * k, h4, w4).clone()
            pseudo_iiu[order_q] = torch.where(iiu['take'][:, None, None], pq,
                                              pseudo_iiu[order_q])
            ts2 = dice_loss_eps(s_flat, pseudo_iiu.reshape(bsz * k, -1))
            loss_ts = loss_ts + cg * (ts2 * vmask).sum() / denom
        gate = use_ts_gate if use_ts_gate is not None else 1.0
        losses = dict(loss_ins=loss_ins, loss_ts=ts_w * loss_ts * gate,
                      loss_cate=loss_cate)
        if corr is not None:
            losses['loss_corr'] = corr[0]
            losses['_corr_append'] = corr[2]
        return losses

    def get_seg(self, outs: Dict[str, torch.Tensor], mask_feat: torch.Tensor,
                test_cfg: Optional[Dict]) -> Dict[str, torch.Tensor]:
        """Prediction from the ``train=False`` outputs and the mask feature
        (reference get_seg_single): ``solo_get_seg`` with DiscoBox's
        defaults."""
        cfg = dict(test_cfg or {})
        return solo_get_seg(
            outs['cates'], outs['kernels'], mask_feat, self.num_grids,
            self.strides, score_thr=float(cfg.get('score_thr', 0.1)),
            mask_thr=float(cfg.get('mask_thr', 0.4)),
            filter_thr=float(cfg.get('filter_thr', 0.05)),
            nms_pre=int(cfg.get('nms_pre', 500)),
            max_per_img=int(cfg.get('max_per_img', 100)),
            kernel=cfg.get('kernel', 'gaussian'),
            sigma=float(cfg.get('sigma', 2.0)))

