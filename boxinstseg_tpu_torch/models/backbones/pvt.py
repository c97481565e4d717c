"""Pyramid Vision Transformer v1 and v2 (NCHW in, NCHW out), counterpart of
``boxinstseg_tpu/models/backbones/pvt.py``: four stages of patch embedding
then spatial-reduction attention and a (conv) FFN per layer.

The config fields are the JAX package's (``embed_dims`` a tuple, one width
per stage); the module names are mmdet's, so an mmdet PVT / PVTv2
``state_dict`` with the same widths loads as it is:
``layers.{i}.0`` the patch embedding (``projection``, ``norm``),
``layers.{i}.1`` the position embedding (v1, ``0.pos_embed``) then the
encoder layers (``norm1``, ``attn.attn.{in_proj_weight, in_proj_bias,
out_proj}``, ``attn.sr``, ``attn.norm``, ``norm2``, ``ffn.layers``: the
1x1 convs at 0 and 3, or 0 and 4 around v2's depthwise conv at 1),
``layers.{i}.2`` the norm after the stage (v2).

The function is the JAX module's:

- the spatial-reduction conv pads as XLA's 'SAME' (``ceil(H / sr)``
  outputs; mmdet's has no padding and gives ``floor``);
- the position embedding is resized with ``ops.upsample.
  interpolate_bilinear`` (float64 source coordinates, ROADMAP D3);
- GELU is exact, LayerNorm's eps 1e-5; no dropout and no drop path
  (``drop_path_rate`` is accepted and not read, D4).

The attention is one ``F.scaled_dot_product_attention`` call (scale
``d ** -0.5``, fp32 accumulation), which keeps no (N, N / sr²) matrix for
the backward.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d
from ...ops.upsample import interpolate_bilinear
from ...registry import BACKBONES


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5)


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero padding of (B, C, H, W) as XLA's 'SAME': ``ceil(size /
    stride)`` outputs, the odd pixel of padding at the end."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int, stride: int,
                 padding: int):
        super().__init__()
        self.projection = Conv2d(in_channels, dim, patch, stride, padding)
        self.norm = _layer_norm(dim)

    def forward(self, x):
        x = self.projection(x)
        return self.norm(x.flatten(2).transpose(1, 2)), x.shape[-2:]


class AbsolutePositionEmbedding(nn.Module):
    """A (1, grid * grid, C) table at the pretraining grid, resized
    bilinearly to the map."""

    def __init__(self, grid: int, dim: int):
        super().__init__()
        self.grid = grid
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid, dim))
        nn.init.trunc_normal_(self.pos_embed, std=0.02)

    def forward(self, tokens, hw):
        pos = self.pos_embed.view(1, self.grid, self.grid, -1) \
            .permute(0, 3, 1, 2)
        pos = interpolate_bilinear(pos, hw)
        return tokens + pos.flatten(2).transpose(1, 2)


class SpatialReductionAttention(nn.Module):
    """Multi-head attention whose keys and values come from the token map
    reduced by an ``sr_ratio``-strided conv. The projections are held in
    an ``nn.MultiheadAttention`` (``attn``) for mmdet's key names; the
    attention itself is ``F.scaled_dot_product_attention``."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.attn = nn.MultiheadAttention(dim, num_heads, batch_first=True)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = _layer_norm(dim)

    def forward(self, x, hw):
        b, n, c = x.shape
        heads, d = self.num_heads, c // self.num_heads
        wq, wk, wv = self.attn.in_proj_weight.chunk(3)
        bq, bk, bv = self.attn.in_proj_bias.chunk(3)
        kv = x
        if self.sr_ratio > 1:
            xm = x.transpose(1, 2).reshape(b, c, *hw)
            xm = self.sr(same_pad(xm, self.sr_ratio, self.sr_ratio))
            kv = self.norm(xm.flatten(2).transpose(1, 2))
        q = F.linear(x, wq, bq).view(b, n, heads, d).transpose(1, 2)
        k = F.linear(kv, wk, bk).view(b, -1, heads, d).transpose(1, 2)
        v = F.linear(kv, wv, bv).view(b, -1, heads, d).transpose(1, 2)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.attn.out_proj(out.transpose(1, 2).reshape(b, n, c))


class MixFFN(nn.Module):
    """1x1 conv, (v2: 3x3 depthwise conv,) exact GELU, 1x1 conv, on the
    token map."""

    def __init__(self, dim: int, hidden: int, use_conv: bool = False):
        super().__init__()
        layers = [Conv2d(dim, hidden, 1), nn.GELU(), nn.Dropout(0.0),
                  Conv2d(hidden, dim, 1), nn.Dropout(0.0)]
        if use_conv:
            layers.insert(1, Conv2d(hidden, hidden, 3, 1, 1, groups=hidden))
        self.layers = nn.Sequential(*layers)

    def forward(self, x, hw):
        b, n, c = x.shape
        y = self.layers(x.transpose(1, 2).reshape(b, c, *hw))
        return y.flatten(2).transpose(1, 2)


class PVTEncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: float, use_conv_ffn: bool = False):
        super().__init__()
        self.norm1 = _layer_norm(dim)
        self.attn = SpatialReductionAttention(dim, num_heads, sr_ratio)
        self.norm2 = _layer_norm(dim)
        self.ffn = MixFFN(dim, int(dim * mlp_ratio), use_conv_ffn)

    def forward(self, x, hw):
        x = x + self.attn(self.norm1(x), hw)
        return x + self.ffn(self.norm2(x), hw)


@BACKBONES.register_module()
class PyramidVisionTransformer(nn.Module):
    """PVT v1 defaults: non-overlapping patch embeddings, absolute position
    embeddings, the plain FFN, no norm after a stage."""

    def __init__(self, pretrain_img_size: int = 224, in_channels: int = 3,
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_stages: int = 4,
                 num_layers: Sequence[int] = (3, 4, 6, 3),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 patch_sizes: Sequence[int] = (4, 2, 2, 2),
                 strides: Sequence[int] = (4, 2, 2, 2),
                 paddings: Sequence[int] = (0, 0, 0, 0),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 mlp_ratios: Sequence[int] = (8, 8, 4, 4),
                 use_abs_pos_embed: bool = True, use_conv_ffn: bool = False,
                 norm_after_stage: bool = False,
                 drop_path_rate: float = 0.1,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.layers = nn.ModuleList()
        cin = in_channels
        for i in range(num_stages):
            dim = embed_dims[i]
            blocks = nn.ModuleList()
            if use_abs_pos_embed:
                blocks.append(AbsolutePositionEmbedding(
                    pretrain_img_size // int(np.prod(strides[:i + 1])), dim))
            blocks.extend(PVTEncoderLayer(dim, num_heads[i], sr_ratios[i],
                                          mlp_ratios[i], use_conv_ffn)
                          for _ in range(num_layers[i]))
            self.layers.append(nn.ModuleList([
                PatchEmbed(cin, dim, patch_sizes[i], strides[i], paddings[i]),
                blocks,
                _layer_norm(dim) if norm_after_stage else nn.Identity()]))
            cin = dim

    def forward(self, x):
        outs = []
        for i, (embed, blocks, norm) in enumerate(self.layers):
            tokens, hw = embed(x)
            for block in blocks:
                tokens = block(tokens, hw)
            x = norm(tokens).transpose(1, 2).reshape(x.shape[0], -1, *hw)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class PyramidVisionTransformerV2(PyramidVisionTransformer):
    """PVTv2 defaults: overlapping patch embeddings, the conv FFN, no
    position embedding, a norm after each stage."""

    def __init__(self, patch_sizes: Sequence[int] = (7, 3, 3, 3),
                 paddings: Sequence[int] = (3, 1, 1, 1),
                 use_abs_pos_embed: bool = False, use_conv_ffn: bool = True,
                 norm_after_stage: bool = True, **kwargs):
        super().__init__(patch_sizes=patch_sizes, paddings=paddings,
                         use_abs_pos_embed=use_abs_pos_embed,
                         use_conv_ffn=use_conv_ffn,
                         norm_after_stage=norm_after_stage, **kwargs)
