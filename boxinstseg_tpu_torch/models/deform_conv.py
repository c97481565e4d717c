"""Deformable convolution (DCNv1 / DCNv2) for the SOLO heads' tower convs,
counterpart of ``boxinstseg_tpu/models/deform_conv.py``.

mmcv's ``DeformConv2dPack`` / ``ModulatedDeformConv2dPack`` key names:
``conv_offset.{weight,bias}`` (a zero-initialised conv over the same
receptive field), ``weight`` (Cout, Cin, kh, kw) and ``bias``.

- Offset channels are ``[dy_0, dx_0, dy_1, dx_1, ...]`` in row-major tap
  order; DCNv2's mask logits are channels ``2K:3K``, through a sigmoid.
- Output pixel (i, j), tap (a, b) samples the input at
  ``(i*sh - ph + a*dh + dy, j*sw - pw + b*dw + dx)``, bilinearly. A sample
  counts where its floor corner lies in ``[-1, size-1]`` on both axes; the
  corners outside the image are zero.
- The contraction runs over (tap, cin) in that tap order, one matmul with
  fp32 accumulation (bf16 operands under autocast).

The bilinear sampling is ``DeformSample``: its forward accumulates the
four corners one after the other into one (B, N, K, C) tensor, and its
backward gathers the corners again, so the step holds one sampled tensor
(about 1.24 GB in fp32 at BoxLevelset's stride-4 feature conv, batch 2,
200x336, 256 channels) where stacking the corners would hold four.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

IntPair = Union[int, Tuple[int, int]]


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _corners(pos_y: torch.Tensor, pos_x: torch.Tensor, h: int, w: int):
    """Per sample (B, N, K): the four corners' rows in the zero-padded
    (B*(H+2)*(W+2)) table, in the order TL, TR, BL, BR, their fp32
    bilinear weights, and the fractions wy, wx with the in-range flag."""
    y0 = torch.floor(pos_y)
    x0 = torch.floor(pos_x)
    wy = pos_y - y0
    wx = pos_x - x0
    ok = ((x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
          ).to(pos_y.dtype)
    # rows of the padded table: corner (y, x) is padded cell (y+1, x+1)
    yi = y0.clamp(-1, h - 1).long() + 1
    xi = x0.clamp(-1, w - 1).long() + 1
    b = pos_y.shape[0]
    base = (torch.arange(b, device=pos_y.device)
            * ((h + 2) * (w + 2))).view(b, *([1] * (pos_y.dim() - 1)))
    tl = base + yi * (w + 2) + xi
    rows = (tl, tl + 1, tl + (w + 2), tl + (w + 3))
    weights = ((1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx)
    return rows, weights, wy, wx, ok


def _table(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B*(H+2)*(W+2), C): channels last, one zero pixel
    around the image."""
    b, c = x.shape[:2]
    return F.pad(x, (1, 1, 1, 1)).permute(0, 2, 3, 1).reshape(-1, c)


class DeformSample(torch.autograd.Function):
    """Bilinear samples of ``x`` (B, C, H, W) at (B, N, K) positions, each
    scaled by ``mask`` (B, N, K) when it is given: (B, N, K, C) in x's
    dtype. The weights are computed in fp32 and cast to x's dtype."""

    @staticmethod
    def forward(ctx, x, pos_y, pos_x, mask):
        h, w = x.shape[-2:]
        table = _table(x)
        rows, weights, _, _, ok = _corners(pos_y, pos_x, h, w)
        scale = ok if mask is None else ok * mask
        out = None
        for r, wt in zip(rows, weights):
            part = table.index_select(0, r.reshape(-1)).view(
                *r.shape, -1) * (wt * scale).to(x.dtype).unsqueeze(-1)
            out = part if out is None else out.add_(part)
        ctx.save_for_backward(x, pos_y, pos_x, mask)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, pos_y, pos_x, mask = ctx.saved_tensors
        h, w = x.shape[-2:]
        table = _table(x)
        rows, weights, wy, wx, ok = _corners(pos_y, pos_x, h, w)
        scale = ok if mask is None else ok * mask
        grad = grad.to(x.dtype)
        # d(weight)/d(wy) and d(weight)/d(wx) of TL, TR, BL, BR
        dy = (-(1 - wx), -wx, 1 - wx, wx)
        dx = (-(1 - wy), 1 - wy, -wy, wy)
        g_table = torch.zeros_like(table) if ctx.needs_input_grad[0] \
            else None
        g_y = torch.zeros_like(pos_y)
        g_x = torch.zeros_like(pos_x)
        g_m = torch.zeros_like(pos_y) if mask is not None else None
        for r, wt, ddy, ddx in zip(rows, weights, dy, dx):
            flat = r.reshape(-1)
            dot = (table.index_select(0, flat).view(*r.shape, -1) * grad
                   ).sum(-1, dtype=torch.float32)
            g_y += dot * ddy
            g_x += dot * ddx
            if g_m is not None:
                g_m += dot * wt
            if g_table is not None:
                g_table.index_add_(0, flat, (grad * (wt * scale).to(
                    grad.dtype).unsqueeze(-1)).reshape(flat.numel(), -1))
        g_y *= scale
        g_x *= scale
        if g_m is not None:
            g_m *= ok
        g_x_in = None
        if g_table is not None:
            b, c = x.shape[:2]
            g_x_in = g_table.view(b, h + 2, w + 2, c)[:, 1:-1, 1:-1] \
                .permute(0, 3, 1, 2).contiguous()
        return g_x_in, g_y, g_x, g_m


class DeformConv2d(nn.Module):
    """Deformable 2D convolution (NCHW). ``modulated=True`` is DCNv2 (a
    per-tap sigmoid mask), False is DCNv1. The offset branch starts at
    zero: at init DCNv1 equals the plain convolution and DCNv2 half of
    it (sigmoid(0) = 0.5)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntPair = 3, stride: IntPair = 1,
                 padding: IntPair = 1, dilation: IntPair = 1,
                 modulated: bool = True, bias: bool = True):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.modulated = modulated
        kh, kw = self.kernel_size
        k = kh * kw
        self.conv_offset = nn.Conv2d(in_channels, (3 if modulated else 2) * k,
                                     self.kernel_size, self.stride,
                                     self.padding, self.dilation)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kh, kw))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        dh, dw = self.dilation
        k = kh * kw
        b, cin = x.shape[:2]
        off = self.conv_offset(x).float()
        oh, ow = off.shape[-2:]
        # (B, K, OH, OW) -> (B, OH*OW, K)
        flat = lambda t: t.flatten(2).transpose(1, 2)  # noqa: E731
        dev = x.device
        tap_y = (torch.arange(kh, device=dev, dtype=torch.float32) * dh
                 ).repeat_interleave(kw)
        tap_x = (torch.arange(kw, device=dev, dtype=torch.float32) * dw
                 ).repeat(kh)
        gy = torch.arange(oh, device=dev, dtype=torch.float32) * sh - ph
        gx = torch.arange(ow, device=dev, dtype=torch.float32) * sw - pw
        base_y = (gy[:, None, None] + tap_y).expand(oh, ow, k).reshape(-1, k)
        base_x = (gx[None, :, None] + tap_x).expand(oh, ow, k).reshape(-1, k)
        pos_y = base_y + flat(off[:, 0:2 * k:2])
        pos_x = base_x + flat(off[:, 1:2 * k:2])
        mask = torch.sigmoid(flat(off[:, 2 * k:])) if self.modulated \
            else None
        smp = DeformSample.apply(x, pos_y, pos_x, mask)     # (B, N, K, C)
        weight = self.weight.permute(0, 2, 3, 1).reshape(-1, k * cin)
        out = smp.reshape(b * oh * ow, k * cin) @ weight.t().to(smp.dtype)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out.view(b, oh, ow, -1).permute(0, 3, 1, 2)
