"""Misc model bricks, counterpart of ``boxinstseg_tpu/models/utils/
bricks.py`` (reference: mmdet/models/utils/{se_layer,inverted_residual,
normed_predictor,conv_upsample,res_layer,brick_wrappers,make_divisible,
misc}.py).

NCHW modules. The modules keep the JAX package's submodule names
(``conv1``, ``conv2``, ``expand_conv``, ...) with the port's ConvModule
keys beneath (``conv``, ``bn`` / ``gn``); ``NormedLinear`` and
``NormedConv2d`` are mmdet's (``weight``, ``bias``). None of the four
shipped methods uses these.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ConvModule, SyncBatchNorm
from ...ops.upsample import interpolate_bilinear


def make_divisible(value, divisor, min_value=None, min_ratio=0.9):
    """Round channels to the nearest divisible value (reference
    make_divisible.py:2-29)."""
    if min_value is None:
        min_value = divisor
    new_value = max(min_value, int(value + divisor / 2) // divisor * divisor)
    if new_value < min_ratio * value:
        new_value += divisor
    return new_value


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """torch's adaptive average pool of (N, C, H, W) (reference
    brick_wrappers.py:15-40): bin i covers [floor(i n / o), ceil((i + 1) n
    / o)); a None entry keeps that axis."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    h, w = x.shape[-2:]
    oh = output_size[0] or h
    ow = output_size[1] or w

    def pool_axis(x, dim, n_in, n_out):
        return torch.cat([x.narrow(dim, (i * n_in) // n_out,
                                   -(-((i + 1) * n_in) // n_out)
                                   - (i * n_in) // n_out).mean(
                                       dim, keepdim=True)
                          for i in range(n_out)], dim=dim)

    return pool_axis(pool_axis(x, x.dim() - 2, h, oh), x.dim() - 1, w, ow)


def interpolate_as(source: torch.Tensor, target) -> torch.Tensor:
    """Bilinear resize of ``source`` ((N, H, W) or (N, C, H, W)) to the
    last two dims of ``target`` (reference misc.py:35-72)."""
    th, tw = target.shape[-2], target.shape[-1]
    if tuple(source.shape[-2:]) != (th, tw):
        source = interpolate_bilinear(source, (th, tw))
    return source


def sigmoid_geometric_mean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(sigmoid(x) sigmoid(y)) (reference misc.py:6-32; its autograd
    function's backward is the analytic gradient)."""
    return torch.sqrt(torch.sigmoid(x) * torch.sigmoid(y))


def scale_target(targets: torch.Tensor,
                 scaled_size: Tuple[int, int] = (96, 96)) -> torch.Tensor:
    """Bilinear rescale of (N, H, W) or (N, C, H, W) mask targets
    (reference misc.py:75-86 _scale_target)."""
    return interpolate_bilinear(targets, scaled_size)


class SELayer(nn.Module):
    """Squeeze-and-Excitation (reference se_layer.py:9-60)."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        self.conv1 = ConvModule(channels, int(channels / ratio), 1)
        self.conv2 = ConvModule(int(channels / ratio), channels, 1, act=None)

    def forward(self, x):
        out = self.conv2(self.conv1(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(out)


class DyReLU(nn.Module):
    """Dynamic ReLU of DyHead (reference se_layer.py:62-134): channel
    attention gives (a1, b1, a2, b2); out = max(x a1 + b1, x a2 + b2)."""

    def __init__(self, channels: int, ratio: int = 4):
        super().__init__()
        self.channels = channels
        self.conv1 = ConvModule(channels, int(channels / ratio), 1)
        self.conv2 = ConvModule(int(channels / ratio), channels * 4, 1,
                                act=None)

    def forward(self, x):
        coeffs = self.conv2(self.conv1(x.mean(dim=(2, 3), keepdim=True)))
        # HSigmoid(bias=3, divisor=6), shifted to [-0.5, 0.5]
        coeffs = ((coeffs + 3.0) / 6.0).clamp(0.0, 1.0) - 0.5
        a1, b1, a2, b2 = torch.split(coeffs, self.channels, dim=1)
        return torch.maximum(x * (a1 * 2.0 + 1.0) + b1, x * (a2 * 2.0) + b2)


class _DepthwiseConv(nn.Module):
    """A depthwise conv without bias, its BN and a ReLU."""

    def __init__(self, channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, kernel_size, stride,
                              kernel_size // 2, groups=channels, bias=False)
        self.bn = SyncBatchNorm(channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InvertedResidual(nn.Module):
    """MobileNetV2 / V3 inverted residual (reference
    inverted_residual.py:11-131): 1x1 expand, depthwise, optional SE, 1x1
    linear; the residual when the stride is 1 and the widths match."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: int, kernel_size: int = 3, stride: int = 1,
                 se_ratio: Optional[int] = None,
                 with_expand_conv: bool = True,
                 norm_cfg: Optional[dict] = None, act: str = 'relu'):
        super().__init__()
        norm = norm_cfg if norm_cfg is not None else dict(type='BN')
        self.expand_conv = ConvModule(in_channels, mid_channels, 1,
                                      norm_cfg=norm, act=act) \
            if with_expand_conv else None
        self.depthwise_conv = _DepthwiseConv(mid_channels, kernel_size,
                                             stride)
        self.se = SELayer(mid_channels, se_ratio) \
            if se_ratio is not None else None
        self.linear_conv = ConvModule(mid_channels, out_channels, 1,
                                      norm_cfg=norm, act=None)
        self.residual = stride == 1 and in_channels == out_channels

    def forward(self, x):
        out = x if self.expand_conv is None else self.expand_conv(x)
        out = self.depthwise_conv(out)
        if self.se is not None:
            out = self.se(out)
        out = self.linear_conv(out)
        return x + out if self.residual else out


class NormedLinear(nn.Linear):
    """Cosine-similarity linear classifier (reference
    normed_predictor.py:11-40): weight rows and inputs L2-normalised (to
    ``power``), scaled by ``tempearture`` [sic]."""

    def __init__(self, in_features: int, out_features: int,
                 tempearture: float = 20.0, power: float = 1.0,
                 eps: float = 1e-6, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.tempearture = tempearture
        self.power = power
        self.eps = eps
        nn.init.normal_(self.weight, 0, 0.01)
        if bias:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        w = self.weight / (torch.linalg.norm(self.weight, dim=1,
                                             keepdim=True) ** self.power
                           + self.eps)
        x = x / (torch.linalg.norm(x, dim=-1, keepdim=True) ** self.power
                 + self.eps)
        return F.linear(x * self.tempearture, w, self.bias)


class NormedConv2d(nn.Conv2d):
    """Cosine-similarity conv head (reference normed_predictor.py:43-80),
    no bias, padding k // 2."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, tempearture: float = 20.0,
                 power: float = 1.0, eps: float = 1e-6,
                 norm_over_kernel: bool = False):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2, bias=False)
        self.tempearture = tempearture
        self.power = power
        self.eps = eps
        self.norm_over_kernel = norm_over_kernel
        nn.init.normal_(self.weight, 0, 0.01)

    def forward(self, x):
        w = self.weight
        if self.norm_over_kernel:
            n = torch.linalg.norm(w.reshape(w.shape[0], -1), dim=1)
            w = w / (n.reshape(-1, 1, 1, 1) ** self.power + self.eps)
        else:
            w = w / (torch.linalg.norm(w, dim=1, keepdim=True) ** self.power
                     + self.eps)
        x = x / (torch.linalg.norm(x, dim=1, keepdim=True) ** self.power
                 + self.eps)
        return F.conv2d(x * self.tempearture, w, padding=self.padding)


class ConvUpsample(nn.Module):
    """``num_layers`` 3x3 convs, a 2x bilinear upsample after each of the
    first ``num_upsample`` (reference conv_upsample.py:7-99)."""

    def __init__(self, in_channels: int, inner_channels: int,
                 num_layers: int = 1, num_upsample: Optional[int] = None,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        self.num_upsample = num_layers if num_upsample is None \
            else num_upsample
        assert self.num_upsample <= num_layers
        self.conv = nn.ModuleList([
            ConvModule(in_channels if i == 0 else inner_channels,
                       inner_channels, 3, padding=1, norm_cfg=norm_cfg)
            for i in range(num_layers)])

    def forward(self, x):
        for i, conv in enumerate(self.conv):
            x = conv(x)
            if i < self.num_upsample:
                x = interpolate_bilinear(x, (x.shape[-2] * 2,
                                             x.shape[-1] * 2))
        return x


class SimplifiedBasicBlock(nn.Module):
    """SCNet's basic block (reference res_layer.py:107-190): 3x3 conv,
    norm, relu; 3x3 conv, norm; the residual; relu."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 with_downsample: bool = False,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        norm = norm_cfg if norm_cfg is not None else dict(type='BN')
        self.conv1 = ConvModule(in_channels, planes, 3, stride=stride,
                                padding=1, norm_cfg=norm)
        self.conv2 = ConvModule(planes, planes, 3, padding=1, norm_cfg=norm,
                                act=None)
        self.downsample = ConvModule(in_channels, planes, 1, stride=stride,
                                     norm_cfg=norm, act=None) \
            if with_downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)
