"""Pixel decoder with a multi-scale deformable-attention encoder,
counterpart of ``boxinstseg_tpu/models/plugins/msdeformattn_pixel_decoder
.py`` (reference: mmdet/models/plugins/msdeformattn_pixel_decoder.py).

The 3 lowest-resolution levels (C5, C4, C3) are flattened into one token
sequence with level encodings and refined by the deformable-attention
encoder layers; the remaining level (C2) gets an FPN-style top-down
pathway, and the stride-4 output feeds a 1x1 mask-feature conv. NCHW maps.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..layers import Conv2d, ConvModule
from ..utils.positional_encoding import SinePositionalEncoding
from ..utils.transformer import DetrTransformerEncoder
from ...ops.upsample import interpolate_bilinear
from ...registry import PLUGINS


@PLUGINS.register_module()
class MSDeformAttnPixelDecoder(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 strides: Sequence[int] = (4, 8, 16, 32),
                 feat_channels: int = 256, out_channels: int = 256,
                 num_outs: int = 3, num_encoder_levels: int = 3,
                 num_encoder_layers: int = 6, num_heads: int = 8,
                 num_points: int = 4, feedforward_channels: int = 1024,
                 norm_cfg: Optional[dict] = None, **unused):
        super().__init__()
        self.num_input = len(in_channels)
        self.num_outs = num_outs
        self.nel = num_encoder_levels
        gn = norm_cfg or dict(type='GN', num_groups=32)
        # reference: ConvModule(1x1, GN, no activation, bias=True), C5 first
        self.input_convs = nn.ModuleList([
            ConvModule(in_channels[self.num_input - i - 1], feat_channels, 1,
                       norm_cfg=gn, act=None, bias=True)
            for i in range(self.nel)])
        self.level_encoding = nn.Embedding(self.nel, feat_channels)
        nn.init.normal_(self.level_encoding.weight)
        self.pe = SinePositionalEncoding(num_feats=feat_channels // 2)
        self.encoder = DetrTransformerEncoder(
            num_encoder_layers, embed_dims=feat_channels,
            num_heads=num_heads, num_levels=self.nel, num_points=num_points,
            feedforward_channels=feedforward_channels)
        n_fpn = self.num_input - self.nel
        self.lateral_convs = nn.ModuleList([
            ConvModule(in_channels[i], feat_channels, 1, norm_cfg=gn,
                       act=None) for i in range(n_fpn)])
        self.output_convs = nn.ModuleList([
            ConvModule(feat_channels, feat_channels, 3, padding=1,
                       norm_cfg=gn, act='relu') for _ in range(n_fpn)])
        self.mask_feature = Conv2d(feat_channels, out_channels, 1)

    def forward(self, feats):
        """feats: (C2..C5) NCHW. Returns (mask_feature (B, C, H4, W4),
        the multi-scale memories from low to high resolution)."""
        b = feats[0].shape[0]
        dev = feats[0].device
        tokens, poss, shapes, refs = [], [], [], []
        for i in range(self.nel):
            x = self.input_convs[i](feats[self.num_input - i - 1])
            h, w = x.shape[-2:]
            pos = self.pe(b, h, w, dev) + self.level_encoding.weight[i]
            # normalised reference points at the grid centres, xy
            ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
            xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
            ref = torch.stack(torch.meshgrid(xs, ys, indexing='xy'), -1)
            tokens.append(x.flatten(2).transpose(1, 2))
            poss.append(pos.reshape(b, h * w, -1))
            shapes.append((h, w))
            refs.append(ref.reshape(1, h * w, 2).expand(b, h * w, 2))
        tokens = torch.cat(tokens, 1)
        poss = torch.cat(poss, 1)
        refs = torch.cat(refs, 1)
        for layer in self.encoder.layers:
            tokens = layer(tokens, poss, shapes, refs)

        outs, start = [], 0
        for h, w in shapes:
            outs.append(tokens[:, start:start + h * w].transpose(1, 2)
                        .reshape(b, -1, h, w))
            start += h * w
        # FPN top-down for the remaining high-resolution levels
        for i in range(self.num_input - self.nel - 1, -1, -1):
            lateral = self.lateral_convs[i](feats[i])
            y = lateral + interpolate_bilinear(outs[-1],
                                               lateral.shape[-2:])
            outs.append(self.output_convs[i](y))
        return self.mask_feature(outs[-1]), outs[:self.num_outs]
