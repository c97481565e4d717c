"""Transformer bricks for Box2Mask, counterpart of
``boxinstseg_tpu/models/utils/transformer.py`` (reference:
mmdet/models/utils/transformer.py and the mmcv bricks).

All blocks are batch-first (B, L, C), without dropout (the shipped configs
set every dropout to 0). Module and parameter names follow mmcv's, so that
a port ``state_dict`` has the reference checkpoint's keys:
``attentions.{i}``, ``ffns.0.layers.{0.0,1}``, ``norms.{i}``; a
``MultiheadAttention`` keeps torch's ``attn.in_proj_weight`` /
``attn.in_proj_bias`` / ``attn.out_proj``. Attention products are plain
``torch.matmul``; deformable attention samples all levels of a layer in
one ``ops.msda.ms_deform_attn`` call (the CUDA kernel pair on the card).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.msda import ms_deform_attn


def LayerNorm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=1e-5)


class _InProjAttention(nn.Module):
    """The parameters of ``torch.nn.MultiheadAttention`` (packed q/k/v
    input projection and the output projection)."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims,
                                                       embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = nn.Linear(embed_dims, embed_dims)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)


class MultiheadAttention(nn.Module):
    """Multi-head attention with an optional boolean mask (True = blocked,
    scored -1e9 before the softmax)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.attn = _InProjAttention(embed_dims)

    def forward(self, query, key, value, attn_mask=None):
        """query (B, Lq, C); key/value (B, Lk, C); attn_mask
        (B, heads, Lq, Lk) bool or None."""
        c, h = self.embed_dims, self.num_heads
        d = c // h
        wq, wk, wv = self.attn.in_proj_weight.chunk(3)
        bq, bk, bv = self.attn.in_proj_bias.chunk(3)
        b, lq, _ = query.shape
        lk = key.shape[1]
        q = F.linear(query, wq, bq).reshape(b, lq, h, d).transpose(1, 2)
        k = F.linear(key, wk, bk).reshape(b, lk, h, d).transpose(1, 2)
        v = F.linear(value, wv, bv).reshape(b, lk, h, d).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask, -1e9)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        out = out.transpose(1, 2).reshape(b, lq, c)
        return self.attn.out_proj(out)


class FFN(nn.Module):
    """fc -> relu -> fc with the residual inside."""

    def __init__(self, embed_dims: int = 256,
                 feedforward_channels: int = 2048):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels),
                          nn.ReLU(inplace=True)),
            nn.Linear(feedforward_channels, embed_dims))

    def forward(self, x):
        return x + self.layers(x)


def msda_offset_bias_init(num_heads, num_levels, num_points) -> np.ndarray:
    """Directional grid init of the sampling offsets, in mmcv's channel
    order [head][level][point][xy] (MultiScaleDeformableAttention.
    init_weights)."""
    thetas = np.arange(num_heads) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)     # (h, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    for p in range(num_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1).astype(np.float32)


class MultiScaleDeformableAttention(nn.Module):
    """Deformable attention over the concatenated levels of ``value``."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 3, num_points: int = 4):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        hlp = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dims, hlp * 2)
        self.attention_weights = nn.Linear(embed_dims, hlp)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                msda_offset_bias_init(num_heads, num_levels, num_points)))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        for lin in (self.value_proj, self.output_proj):
            nn.init.xavier_uniform_(lin.weight)
            nn.init.zeros_(lin.bias)

    def forward(self, query: torch.Tensor, value: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]],
                reference_points: torch.Tensor) -> torch.Tensor:
        """query (B, L, C); value (B, S, C), the levels concatenated;
        spatial_shapes [(h, w)] per level; reference_points (B, L, 2)
        normalised xy, shared across levels."""
        c, h = self.embed_dims, self.num_heads
        nl, npnt = self.num_levels, self.num_points
        b, l, _ = query.shape
        v = self.value_proj(value).reshape(b, value.shape[1], h, c // h)
        offsets = self.sampling_offsets(query).reshape(b, l, h, nl, npnt, 2)
        attn = torch.softmax(self.attention_weights(query).reshape(
            b, l, h, nl * npnt), dim=-1).reshape(b, l, h, nl, npnt)
        return self.output_proj(ms_deform_attn(v, spatial_shapes,
                                               reference_points, offsets,
                                               attn))


class DetrTransformerEncoderLayer(nn.Module):
    """(deformable self-attention, norm, ffn, norm), post-norm."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 3, num_points: int = 4,
                 feedforward_channels: int = 1024):
        super().__init__()
        self.attentions = nn.ModuleList([MultiScaleDeformableAttention(
            embed_dims, num_heads, num_levels, num_points)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims)
                                    for _ in range(2)])

    def forward(self, x, pos, spatial_shapes, reference_points):
        attn = self.attentions[0](x + pos, x, spatial_shapes,
                                  reference_points)
        x = self.norms[0](x + attn)
        return self.norms[1](self.ffns[0](x))


class DetrTransformerDecoderLayer(nn.Module):
    """(cross-attention, norm, self-attention, norm, ffn, norm),
    post-norm: the operation order of the Box2Mask config."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 2048):
        super().__init__()
        self.attentions = nn.ModuleList([
            MultiheadAttention(embed_dims, num_heads) for _ in range(2)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels)])
        self.norms = nn.ModuleList([LayerNorm(embed_dims)
                                    for _ in range(3)])

    def forward(self, query, key, value, query_pos, key_pos,
                cross_attn_mask: Optional[torch.Tensor] = None):
        ca = self.attentions[0](query + query_pos, key + key_pos, value,
                                attn_mask=cross_attn_mask)
        query = self.norms[0](query + ca)
        qp = query + query_pos
        sa = self.attentions[1](qp, qp, query)
        query = self.norms[1](query + sa)
        return self.norms[2](self.ffns[0](query))


class DetrTransformerEncoder(nn.Module):
    """Holds the encoder layers under mmcv's ``layers.{i}`` names."""

    def __init__(self, num_layers: int, **layer_kwargs):
        super().__init__()
        self.layers = nn.ModuleList([DetrTransformerEncoderLayer(
            **layer_kwargs) for _ in range(num_layers)])


class DetrTransformerDecoder(nn.Module):
    """Holds the decoder layers (``layers.{i}``) and the ``post_norm``;
    the head runs them one by one between its mask predictions."""

    def __init__(self, num_layers: int, embed_dims: int = 256,
                 num_heads: int = 8, feedforward_channels: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList([DetrTransformerDecoderLayer(
            embed_dims, num_heads, feedforward_channels)
            for _ in range(num_layers)])
        self.post_norm = LayerNorm(embed_dims)
