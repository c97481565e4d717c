"""The plain pixel decoders of MaskFormer-style heads, counterpart of
``boxinstseg_tpu/models/plugins/pixel_decoder.py`` (reference:
mmdet/models/plugins/pixel_decoder.py — PixelDecoder :12-113, an FPN-shaped
top-down fuse; TransformerEncoderPixelDecoder :115-243, which first runs a
full-attention transformer encoder on the lowest-resolution level).

NCHW maps, mmdet's module names (``lateral_convs.{i}``,
``output_convs.{i}``, ``last_feat_conv``, ``encoder_in_proj``,
``encoder.layers.{i}``, ``encoder_out_proj``, ``mask_feature``), so that a
reference ``state_dict`` loads. No shipped config uses them (Box2Mask uses
``MSDeformAttnPixelDecoder``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..layers import Conv2d, ConvModule
from ..utils.positional_encoding import SinePositionalEncoding
from ..utils.transformer import FFN, LayerNorm, MultiheadAttention


def upsample_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest resize of (..., H, W) to (h, w) as ``jax.image.resize``:
    source index floor((i + 0.5) * in / out), in float32."""
    def index(n_in, n_out):
        src = (torch.arange(n_out, dtype=torch.float32, device=x.device)
               + 0.5) * n_in / n_out
        return torch.floor(src).long().clamp(max=n_in - 1)
    return x.index_select(-2, index(x.shape[-2], h)).index_select(
        -1, index(x.shape[-1], w))


class _TopDown(nn.Module):
    """The laterals and 3x3 output convs of every level but the last, and
    the 3x3 mask-feature conv."""

    def __init__(self, in_channels, feat_channels, out_channels, norm_cfg):
        super().__init__()
        norm = norm_cfg if norm_cfg is not None \
            else dict(type='GN', num_groups=32)
        n = len(in_channels)
        self.lateral_convs = nn.ModuleList([
            ConvModule(in_channels[i], feat_channels, 1, norm_cfg=norm,
                       act=None) for i in range(n - 1)])
        self.output_convs = nn.ModuleList([
            ConvModule(feat_channels, feat_channels, 3, padding=1,
                       norm_cfg=norm) for _ in range(n - 1)])
        self.mask_feature = Conv2d(feat_channels, out_channels, 3,
                                   padding=1)
        self.norm = norm

    def fuse(self, feats, y):
        for i in range(len(feats) - 2, -1, -1):
            cur = self.lateral_convs[i](feats[i])
            y = cur + upsample_nearest(y, cur.shape[-2], cur.shape[-1])
            y = self.output_convs[i](y)
        return self.mask_feature(y)


class PixelDecoder(_TopDown):
    """FPN-shaped pixel decoder: laterals on all but the last input, 3x3
    output convs top-down, a stride-4 mask feature (reference
    pixel_decoder.py:12-113)."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 feat_channels: int = 256, out_channels: int = 256,
                 norm_cfg: Optional[dict] = None):
        super().__init__(in_channels, feat_channels, out_channels, norm_cfg)
        self.last_feat_conv = ConvModule(in_channels[-1], feat_channels, 3,
                                         padding=1, norm_cfg=self.norm)

    def forward(self, feats):
        """feats: NCHW, low to high stride. Returns (mask_feature
        (B, out, H/4, W/4), memory = the last level)."""
        return self.fuse(feats, self.last_feat_conv(feats[-1])), feats[-1]


class TransformerEncoderLayer(nn.Module):
    """('self_attn', 'norm', 'ffn', 'norm') post-norm layer with full
    self-attention (the JAX ``TransformerEncoderLayer``; mmcv's
    BaseTransformerLayer keys)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 1024):
        super().__init__()
        self.attentions = nn.ModuleList([MultiheadAttention(embed_dims,
                                                            num_heads)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims)
                                    for _ in range(2)])

    def forward(self, x, pos):
        xp = x + pos
        x = self.norms[0](x + self.attentions[0](xp, xp, x))
        return self.norms[1](self.ffns[0](x))


class TransformerEncoder(nn.Module):
    """A stack of full-attention encoder layers (``layers.{i}``)."""

    def __init__(self, num_layers: int = 6, **layer_kwargs):
        super().__init__()
        self.layers = nn.ModuleList([TransformerEncoderLayer(**layer_kwargs)
                                     for _ in range(num_layers)])

    def forward(self, x, pos):
        for layer in self.layers:
            x = layer(x, pos)
        return x


class TransformerEncoderPixelDecoder(_TopDown):
    """PixelDecoder whose last level a full-attention transformer encoder
    refines first (reference pixel_decoder.py:115-243); ``memory`` is the
    encoder's output."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 feat_channels: int = 256, out_channels: int = 256,
                 norm_cfg: Optional[dict] = None,
                 num_encoder_layers: int = 6, num_heads: int = 8,
                 feedforward_channels: int = 2048):
        super().__init__(in_channels, feat_channels, out_channels, norm_cfg)
        self.encoder_in_proj = Conv2d(in_channels[-1], feat_channels, 1)
        self.positional_encoding = SinePositionalEncoding(feat_channels // 2)
        self.encoder = TransformerEncoder(
            num_encoder_layers, embed_dims=feat_channels,
            num_heads=num_heads, feedforward_channels=feedforward_channels)
        self.encoder_out_proj = ConvModule(feat_channels, feat_channels, 3,
                                           padding=1, norm_cfg=self.norm)

    def forward(self, feats):
        x = self.encoder_in_proj(feats[-1])
        b, c, h, w = x.shape
        pos = self.positional_encoding(b, h, w, x.device).reshape(b, h * w, c)
        memory = self.encoder(x.flatten(2).transpose(1, 2), pos)
        memory = memory.transpose(1, 2).reshape(b, c, h, w)
        return self.fuse(feats, self.encoder_out_proj(memory)), memory
