"""Swin Transformer backbone, counterpart of
``boxinstseg_tpu/models/backbones/swin.py`` (reference:
mmdet/models/backbones/swin.py).

mmdet's module layout, so that a reference Swin ``state_dict`` loads with
no converter and the Swin recipes' ``custom_keys`` match by substring:
``patch_embed.{projection,norm}``, ``stages.{i}.blocks.{j}.{norm1,
attn.w_msa.{qkv,proj,relative_position_bias_table}, norm2, ffn.layers.0.0,
ffn.layers.1}``, ``stages.{i}.downsample.{norm,reduction}`` and
``norm{i}``. Input and outputs are NCHW; the blocks run channels-last.

The JAX package's behaviours, which the port keeps:

- a block's window is ``ws = min(window_size, h, w)`` and its shift drops
  to 0 when ``ws`` shrinks (mmdet keeps the window and pads). The table
  stays ``(2*window_size - 1)**2`` rows; a shrunk window reads the rows of
  its own offsets;
- LayerNorm, zero pad to a multiple of ``ws``, roll by ``-shift``; window
  attention; reverse, roll back, crop. Padded tokens attend like others;
- exact-erf GELU, LayerNorm eps 1e-5;
- a stage's output norm ``norm{i}`` is applied before the patch merging;
- PatchMerging pads an odd map at the bottom and right and keeps mmcv's
  ``nn.Unfold`` channel order ``c*4 + (ky*2 + kx)``;
- stochastic depth is off: the JAX train step passes no dropout rng, so
  its ``_drop_path`` is the identity. ``drop_path_rate`` is kept in the
  config and not applied;
- ``frozen_stages`` cuts autograd after the stage (the JAX
  ``stop_gradient``): the patch embedding and the blocks of a frozen stage
  run with autograd off; its output norm and merging do not.

Window attention goes through ``ops.swin_attention.window_attention_qkv``:
the K5 / K6 CUDA kernels on the card, the plain versions on the CPU.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.swin_attention import shift_regions, window_attention_qkv
from ...registry import BACKBONES


def _rel_pos_index(ws: int, table_ws: Optional[int] = None) -> np.ndarray:
    """(N, N) rows of the relative-position table of window ``table_ws``
    (default ``ws``) for the offsets of a ``ws`` window."""
    t = table_ws or ws
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing='ij'))            # 2, ws, ws
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]                # 2, n, n
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += t - 1
    rel[:, :, 1] += t - 1
    rel[:, :, 0] *= 2 * t - 1
    return rel[:, :, 0] + rel[:, :, 1]                       # n, n


def _device_constant(make, *key):
    """``make(*key)`` as a tensor on the key's last item, the device: kept
    for the next call, except while ``torch.export`` traces (a tensor made
    then is a fake one, which must not outlive the trace)."""
    if torch.compiler.is_compiling():
        return make.__wrapped__(*key)
    return make(*key)


@functools.lru_cache(maxsize=None)
def _regions_tensor(hp, wp, ws, shift, device):
    return torch.from_numpy(shift_regions(hp, wp, ws, shift)).to(device)


@functools.lru_cache(maxsize=None)
def _shrunk_index_tensor(ws, table_ws, device):
    return torch.from_numpy(_rel_pos_index(ws, table_ws)).to(device)


def _regions(hp, wp, ws, shift, device):
    return _device_constant(_regions_tensor, hp, wp, ws, shift, device)


def _shrunk_index(ws, table_ws, device):
    return _device_constant(_shrunk_index_tensor, ws, table_ws, device)


def _linear(cin, cout, bias=True):
    """mmdet Swin init: truncated normal (std 0.02), zero bias."""
    lin = nn.Linear(cin, cout, bias=bias)
    nn.init.trunc_normal_(lin.weight, std=0.02)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def LayerNorm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=1e-5)


class WindowMSA(nn.Module):
    """Window multi-head self-attention with relative-position bias."""

    def __init__(self, embed_dims: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.scale = (embed_dims // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer('relative_position_index', torch.from_numpy(
            _rel_pos_index(window_size)))
        self.qkv = _linear(embed_dims, embed_dims * 3, bias=qkv_bias)
        self.proj = _linear(embed_dims, embed_dims)

    def forward(self, x, regions, ws):
        """x (BW, ws*ws, C); regions (nW, 1, ws*ws) int32."""
        n = ws * ws
        index = self.relative_position_index if ws == self.window_size \
            else _shrunk_index(ws, self.window_size, x.device)
        bias = self.relative_position_bias_table[index.reshape(-1)].reshape(
            n, n, self.num_heads).permute(2, 0, 1)
        out = window_attention_qkv(self.qkv(x), bias, regions, self.scale)
        return self.proj(out)


class ShiftWindowMSA(nn.Module):
    def __init__(self, embed_dims, num_heads, window_size, shift_size=0,
                 qkv_bias=True):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.w_msa = WindowMSA(embed_dims, num_heads, window_size, qkv_bias)

    def forward(self, x):
        """x (B, H, W, C) -> (B, H, W, C)."""
        b, h, w, c = x.shape
        ws = min(self.window_size, h, w)
        shift = self.shift_size if ws == self.window_size else 0
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), (1, 2))
        wins = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        wins = self.w_msa(wins, _regions(hp, wp, ws, shift, x.device), ws)
        x = wins.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift > 0:
            x = torch.roll(x, (shift, shift), (1, 2))
        return x[:, :h, :w]


class SwinFFN(nn.Module):
    """fc -> exact GELU -> fc (mmcv FFN names ``layers.0.0``, ``layers.1``);
    the residual is the block's."""

    def __init__(self, embed_dims, feedforward_channels):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(_linear(embed_dims, feedforward_channels),
                          nn.GELU()),
            _linear(feedforward_channels, embed_dims))

    def forward(self, x):
        return self.layers(x)


class SwinBlock(nn.Module):
    def __init__(self, embed_dims, num_heads, feedforward_channels,
                 window_size=7, shift=False, qkv_bias=True):
        super().__init__()
        self.norm1 = LayerNorm(embed_dims)
        self.attn = ShiftWindowMSA(embed_dims, num_heads, window_size,
                                   window_size // 2 if shift else 0,
                                   qkv_bias)
        self.norm2 = LayerNorm(embed_dims)
        self.ffn = SwinFFN(embed_dims, feedforward_channels)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbourhood in mmcv's unfold order -> LayerNorm -> Linear(2C);
    an odd map is padded at the bottom and right."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.norm = LayerNorm(4 * in_channels)
        self.reduction = _linear(4 * in_channels, out_channels, bias=False)

    def forward(self, x):
        """x (B, H, W, C) -> (B, ceil(H/2), ceil(W/2), out_channels)."""
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        h2, w2 = (h + 1) // 2, (w + 1) // 2
        x = x.reshape(b, h2, 2, w2, 2, c).permute(0, 1, 3, 5, 2, 4)
        return self.reduction(self.norm(x.reshape(b, h2, w2, 4 * c)))


class SwinBlockSequence(nn.Module):
    def __init__(self, embed_dims, num_heads, feedforward_channels, depth,
                 window_size, qkv_bias, downsample):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(embed_dims, num_heads, feedforward_channels,
                      window_size, shift=i % 2 == 1, qkv_bias=qkv_bias)
            for i in range(depth)])
        self.downsample = PatchMerging(embed_dims, 2 * embed_dims) \
            if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, in_channels, embed_dims, patch_size, norm):
        super().__init__()
        self.projection = nn.Conv2d(in_channels, embed_dims, patch_size,
                                    patch_size)
        self.norm = LayerNorm(embed_dims) if norm else None

    def forward(self, x):
        """x (B, 3, H, W) -> (B, H/p, W/p, C)."""
        x = self.projection(x).permute(0, 2, 3, 1)
        return self.norm(x) if self.norm is not None else x


@BACKBONES.register_module()
class SwinTransformer(nn.Module):
    """Swin Transformer; returns the NCHW outputs of ``out_indices``."""

    def __init__(self, pretrain_img_size: int = 224, patch_size: int = 4,
                 in_channels: int = 3,
                 embed_dims: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.3, patch_norm: bool = True,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, with_cp: bool = False,
                 convert_weights: bool = True,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        if drop_rate or attn_drop_rate or qk_scale is not None:
            raise NotImplementedError('Swin dropout and qk_scale are not '
                                      'ported (the shipped configs leave '
                                      'them unset)')
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.drop_path_rate = drop_path_rate      # kept, not applied
        self.patch_embed = PatchEmbed(in_channels, embed_dims,
                                      patch_size, patch_norm)
        self.stages = nn.ModuleList()
        dim = embed_dims
        for i, depth in enumerate(self.depths):
            self.stages.append(SwinBlockSequence(
                dim, num_heads[i], int(mlp_ratio * dim), depth, window_size,
                qkv_bias, downsample=i < len(self.depths) - 1))
            if i in self.out_indices:
                self.add_module(f'norm{i}', LayerNorm(dim))
            if i < len(self.depths) - 1:
                dim *= 2

    def forward(self, x):
        grad = torch.is_grad_enabled()
        with torch.set_grad_enabled(grad and self.frozen_stages < 1):
            x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.stages):
            with torch.set_grad_enabled(grad and i >= self.frozen_stages):
                for block in stage.blocks:
                    x = block(x)
            if i in self.out_indices:
                outs.append(getattr(self, f'norm{i}')(x).permute(0, 3, 1, 2)
                            .contiguous())
            if stage.downsample is not None:
                x = stage.downsample(x)
        return tuple(outs)
