"""Box2Mask head: masked-attention transformer decoder with box-supervised
level-set losses, counterpart of
``boxinstseg_tpu/models/dense_heads/box2mask_head.py`` (reference:
mmdet/models/dense_heads/box2mask_head.py).

- MSDeformAttn pixel decoder and a masked-attention decoder with learned
  query features / positions and level embeddings;
- ``forward_head`` per decoder output: class logits, mask embedding, mask
  logits (embedding x mask feature) and the next layer's attention mask;
- ``loss``: one batched Hungarian match for all decoder outputs
  (ClassificationCost + BoxMatchingCost), then per output the CE class
  loss (background weight 0.1), the projection dice (x5), the image
  level-set (x0.05), the tree-filtered level-set at ``tf_size`` (x5) and
  the LCM term (x0.2). The matched masks of all outputs go through one
  tree-filter call per tree and one LCM refinement.

Maps are NCHW; the tree filter takes channels-last maps as the JAX package
does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d
from ..losses.levelset_loss import (LocalConsistencyModule,
                                    region_levelset,
                                    region_levelset_shared)
from ..plugins.msdeformattn_pixel_decoder import MSDeformAttnPixelDecoder
from ..utils.positional_encoding import SinePositionalEncoding
from ..utils.transformer import DetrTransformerDecoder
from ...core.targets.hungarian import (box_matching_cost,
                                       classification_cost, hungarian_match)
from ...ops.tree_filter import grid_mst_pair, tree_filter2d
from ...ops.upsample import interpolate_bilinear
from ...parallel import dist as pdist
from ...registry import HEADS


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@HEADS.register_module()
class Box2MaskHead(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 strides: Sequence[int] = (4, 8, 16, 32),
                 feat_channels: int = 256, out_channels: int = 256,
                 num_things_classes: int = 80, num_stuff_classes: int = 0,
                 num_queries: int = 100, num_transformer_feat_level: int = 3,
                 pixel_decoder: Optional[dict] = None,
                 enforce_decoder_input_project: bool = False,
                 transformer_decoder: Optional[dict] = None,
                 positional_encoding: Optional[dict] = None,
                 loss_cls: Optional[dict] = None,
                 loss_box: Optional[dict] = None,
                 loss_mask: Optional[dict] = None,
                 train_cfg: Optional[dict] = None,
                 test_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None,
                 max_matched: int = 100,
                 tf_size: Tuple[int, int] = (96, 96),
                 tf_max_depth: int = 0):
        super().__init__()
        self.num_classes = num_things_classes + num_stuff_classes
        self.num_queries = num_queries
        self.nfl = num_transformer_feat_level
        self.feat_channels = feat_channels
        self.loss_cls_cfg = loss_cls or {}
        self.loss_box_cfg = loss_box or {}
        self.loss_mask_cfg = loss_mask or {}
        self.train_cfg = train_cfg or {}
        self.max_matched = max_matched
        self.tf_size = tuple(tf_size)
        self.tf_max_depth = tf_max_depth

        td = transformer_decoder or {}
        tl = td.get('transformerlayers', {})
        self.num_layers = td.get('num_layers', 9)
        self.num_heads = (tl.get('attn_cfgs') or {}).get('num_heads', 8)
        ffc = tl.get('feedforward_channels', 2048)

        pd_cfg = {k: v for k, v in dict(pixel_decoder or {}).items()
                  if k in ('num_outs', 'num_encoder_layers', 'norm_cfg')}
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            in_channels=in_channels, strides=strides,
            feat_channels=feat_channels, out_channels=out_channels,
            **pd_cfg)
        self.transformer_decoder = DetrTransformerDecoder(
            self.num_layers, feat_channels, self.num_heads, ffc)
        self.pe = SinePositionalEncoding(num_feats=feat_channels // 2)
        self.query_embed = nn.Embedding(num_queries, feat_channels)
        self.query_feat = nn.Embedding(num_queries, feat_channels)
        self.level_embed = nn.Embedding(self.nfl, feat_channels)
        self.cls_embed = nn.Linear(feat_channels, self.num_classes + 1)
        self.mask_embed = nn.Sequential(
            nn.Linear(feat_channels, feat_channels), nn.ReLU(inplace=True),
            nn.Linear(feat_channels, feat_channels), nn.ReLU(inplace=True),
            nn.Linear(feat_channels, out_channels))
        self.levelset_bottom = Conv2d(out_channels, 1, 3, 1, 1)
        for emb in (self.query_embed, self.query_feat, self.level_embed):
            nn.init.normal_(emb.weight)

    # ------------------------------------------------------------- forward
    def forward_head(self, query, mask_features, target_hw):
        """Class logits (B, Q, C+1), mask embedding (B, Q, C), mask logits
        (B, Q, H4, W4) and the boolean attention mask (B, heads, Q, h*w)
        at ``target_hw`` (True = blocked; a row that would block every
        position is unblocked)."""
        out = self.transformer_decoder.post_norm(query)
        cls_pred = self.cls_embed(out)
        me = self.mask_embed(out)
        mask_pred = torch.einsum('bqc,bchw->bqhw', me, mask_features)
        with torch.no_grad():
            b, q = mask_pred.shape[:2]
            am = interpolate_bilinear(mask_pred, target_hw)
            am = (torch.sigmoid(am) < 0.5).reshape(b, q, -1)
            am = am & ~am.all(dim=-1, keepdim=True)
            am = am[:, None].expand(b, self.num_heads, q, am.shape[-1])
        return cls_pred, me, mask_pred, am

    def forward(self, feats):
        """feats (C2..C5) NCHW. Returns the class logits and mask
        embeddings of all ``num_layers + 1`` decoder outputs, the last mask
        logits, the mask feature and the level-set feature."""
        mask_features, memories = self.pixel_decoder(feats)
        b = feats[0].shape[0]
        c = self.feat_channels
        dec_inputs, dec_pos, dec_hw = [], [], []
        for i in range(self.nfl):
            m = memories[i]
            h, w = m.shape[-2:]
            dec_inputs.append(m.flatten(2).transpose(1, 2)
                              + self.level_embed.weight[i])
            dec_pos.append(self.pe(b, h, w, m.device).reshape(b, h * w, c))
            dec_hw.append((h, w))

        queries = self.query_feat.weight[None].expand(b, -1, -1)
        qpos = self.query_embed.weight[None].expand(b, -1, -1)
        cls_list, embed_list = [], []
        cls_pred, me, mask_pred, attn_mask = self.forward_head(
            queries, mask_features, dec_hw[0])
        cls_list.append(cls_pred)
        embed_list.append(me)
        for i, layer in enumerate(self.transformer_decoder.layers):
            lvl = i % self.nfl
            queries = layer(queries, dec_inputs[lvl], dec_inputs[lvl], qpos,
                            dec_pos[lvl], cross_attn_mask=attn_mask)
            cls_pred, me, mask_pred, attn_mask = self.forward_head(
                queries, mask_features, dec_hw[(i + 1) % self.nfl])
            cls_list.append(cls_pred)
            embed_list.append(me)
        return dict(cls=cls_list, mask_embeds=embed_list, masks=[mask_pred],
                    mask_feature=mask_features,
                    levelset_feat=self.levelset_bottom(mask_features))

    # ---------------------------------------------------------------- loss
    def loss(self, outs: Dict, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """batch: image (B, 3, H, W), gt_labels (B, G), gt_valid (B, G),
        gt_masks (B, G, H4, W4) box bitmasks at the mask-feature stride."""
        cls_w = self.loss_cls_cfg.get('loss_weight', 2.0)
        assigner = self.train_cfg.get('assigner', {})
        cls_cost_w = assigner.get('cls_cost', {}).get('weight', 2.0)
        dice_cost_w = assigner.get('dice_cost', {}).get('weight', 5.0)
        box_w = self.loss_box_cfg.get('loss_weight', 5.0)
        ls_w = self.loss_mask_cfg.get('loss_weight', 1.0)

        gt_labels = batch['gt_labels'].long()
        gt_valid = batch['gt_valid'].bool()
        gt_masks = batch['gt_masks'].float()
        B, G = gt_labels.shape
        K = min(self.max_matched, G)
        Q = self.num_queries
        mask_feature = outs['mask_feature']
        h4, w4 = mask_feature.shape[-2:]
        dev = mask_feature.device
        class_weight = torch.ones(self.num_classes + 1, device=dev)
        class_weight[-1] = 0.1

        # a fixed-capacity subset of GTs per image, valid slots first
        order = torch.argsort((~gt_valid).to(torch.uint8), dim=1,
                              stable=True)[:, :K]
        k_valid = torch.gather(gt_valid, 1, order)
        k_labels = torch.gather(gt_labels, 1, order)
        k_masks = gt_masks[torch.arange(B, device=dev)[:, None], order]
        mv = k_valid.float()
        mdenom = pdist.reduce_mean_denominator(mv.sum(), 1.0)

        # per-image structures shared by the tree and LCM terms
        th, tw = self.tf_size
        image = batch['image']
        img4 = interpolate_bilinear(image, (h4, w4))
        img96 = interpolate_bilinear(image, (th, tw))
        lst96 = interpolate_bilinear(outs['levelset_feat'], (th, tw))
        box96 = interpolate_bilinear(k_masks, (th, tw))
        tf_md = self.tf_max_depth or th * tw
        (parent_i, depth_i), (parent_l, depth_l) = grid_mst_pair(
            _nhwc(img96), _nhwc(lst96), tf_md)

        cls_stack = outs['cls']
        n_layers = len(cls_stack)
        mask_preds = [torch.einsum('bqc,bchw->bqhw', me, mask_feature)
                      for me in outs['mask_embeds']]

        # the Hungarian match of all decoder outputs: one LSA solve on the
        # costs' device (the LSA kernel on the card)
        with torch.no_grad():
            costs = torch.stack([
                cls_cost_w * classification_cost(cp, k_labels)
                + dice_cost_w * box_matching_cost(mp, k_masks)
                for cp, mp in zip(cls_stack, mask_preds)])   # (L, B, Q, K)
            assigned, _ = hungarian_match(
                costs.reshape(n_layers * B, Q, K),
                k_valid.repeat(n_layers, 1))
            assigned = assigned.reshape(n_layers, B, K)

        pix = torch.clamp(k_masks.sum(dim=(2, 3)), min=1.0)
        bidx = torch.arange(B, device=dev)[:, None]
        per_layer: List[Dict[str, torch.Tensor]] = []
        layer_m96 = []
        for cls_pred, mask_pred, asg in zip(cls_stack, mask_preds,
                                            assigned):
            # labels per query; unmatched queries are background
            aq = torch.where(k_valid, asg, torch.full_like(asg, Q))
            labels = torch.full((B, Q + 1), self.num_classes,
                                dtype=torch.long, device=dev)
            labels.scatter_(1, aq, k_labels)
            labels = labels[:, :Q]
            ce = -torch.gather(F.log_softmax(cls_pred, dim=-1), 2,
                               labels[..., None])[..., 0]
            wts = class_weight[labels]
            loss_cls = cls_w * (ce * wts).sum() \
                / pdist.reduce_mean_denominator(wts.sum(), 1.0)

            mscore = torch.sigmoid(mask_pred[bidx, asg])     # (B, K, H, W)

            def d1(a, t):
                inter = (a * t).sum(-1)
                den = (a ** 2).sum(-1) + (t ** 2).sum(-1) + 1e-5
                return 1.0 - 2.0 * inter / den

            proj = d1(mscore.amax(dim=2), k_masks.amax(dim=2)) \
                + d1(mscore.amax(dim=3), k_masks.amax(dim=3))
            loss_project = box_w * (proj * mv).sum() / mdenom
            ls_img = region_levelset_shared(mscore, k_masks, img4) / pix
            loss_img = 0.05 * ls_w * (ls_img * mv).sum() / mdenom
            per_layer.append(dict(loss_cls=loss_cls,
                                  loss_project=loss_project,
                                  loss_img=loss_img))
            layer_m96.append(interpolate_bilinear(mscore, (th, tw)))

        # the tree-filtered structural term, all outputs in one call each
        all96 = torch.cat(layer_m96, dim=1)                 # (B, L*K, t, t)
        deep_img = tree_filter2d(_nhwc(all96), _nhwc(img96), parent_i,
                                 depth_i, sigma=0.02, low_tree=True,
                                 max_depth=tf_md)
        deep_lst = tree_filter2d(deep_img, _nhwc(lst96), parent_l, depth_l,
                                 low_tree=False, max_depth=tf_md)
        # LCM, all outputs batched (affinity from the image only)
        refined = LocalConsistencyModule(dilations=(2,), num_iter=10)(
            img96, all96)

        def to_lk(x):          # (B, t, t, L*K) -> (L, B, K, t, t)
            return x.reshape(B, th, tw, n_layers, K).permute(3, 0, 4, 1, 2)

        di_stack, dl_stack = to_lk(deep_img), to_lk(deep_lst)
        m96_stack = all96.reshape(B, n_layers, K, th, tw).transpose(0, 1)
        ref_stack = refined.reshape(B, n_layers, K, th, tw).transpose(0, 1)
        pix96 = torch.clamp(box96.sum(dim=(2, 3)), min=1.0).reshape(-1)
        box_mv = box96 * mv[..., None, None]
        lcm_den = pdist.reduce_mean_denominator(box_mv.sum(), 1.0)

        losses: Dict[str, torch.Tensor] = {}
        for li in range(n_layers):
            di, dl, m96, ref = (di_stack[li], dl_stack[li], m96_stack[li],
                                ref_stack[li])
            high = torch.stack([di, dl], dim=2) * box96[:, :, None]
            phi96 = torch.stack([m96, 1.0 - m96], dim=2) * box96[:, :, None]
            ls_hi = region_levelset(phi96.reshape(B * K, 2, th, tw),
                                    high.reshape(B * K, 2, th, tw)) / pix96
            loss_feat = 5.0 * ls_w * (ls_hi * mv.reshape(-1)).sum() / mdenom
            loss_lcm = 0.2 * ((ref - m96).abs() * box_mv).sum() / lcm_den
            pl = per_layer[li]
            prefix = '' if li == n_layers - 1 else f'd{li}.'
            losses[f'{prefix}loss_cls'] = pl['loss_cls']
            losses[f'{prefix}loss_project'] = pl['loss_project']
            losses[f'{prefix}loss_levelset'] = pl['loss_img'] + (
                loss_feat + loss_lcm)
        return losses
