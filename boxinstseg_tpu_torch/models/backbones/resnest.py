"""ResNeSt backbone (NCHW, frozen BN), counterpart of
``boxinstseg_tpu/models/backbones/resnest.py``: the deep stem, then
bottlenecks whose 3x3 conv is a split-attention conv (a radix-way grouped
conv, gates from the global average, a softmax over the radix within each
group).

The function is the JAX package's, which departs from mmdet's ResNeSt
(ROADMAP F9):

- the bottleneck is ``int(planes * base_width / 64) * groups`` wide, also
  at ``groups == 1`` (mmdet: ``planes``);
- a stride-2 block pools (3x3, padding 1, zeros counted) *before* the
  split-attention conv (mmdet: after it);
- the shortcut pools with no padding and rounds down (mmdet: ``ceil_mode``),
  so a stride-2 block takes even maps only.

Names follow mmdet's (``stem.{0,1,3,4,6,7}``, ``conv2.{conv,bn0,fc1,bn1,
fc2}``, ``downsample.{1,2}``), but the widths differ, so an mmdet ResNeSt
checkpoint does not load.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d, FrozenBatchNorm, max_pool_torch
from .resnet import make_deep_stem
from ...registry import BACKBONES

_ARCH = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
    200: (3, 24, 36, 3),
}


class SplitAttentionConv(nn.Module):
    """Radix-way split attention over a 3x3 conv (mmdet
    ``SplitAttentionConv2d``)."""

    def __init__(self, in_channels: int, channels: int, groups: int = 1,
                 radix: int = 2, reduction_factor: int = 4):
        super().__init__()
        self.radix = radix
        self.groups = groups
        self.channels = channels
        inter = max(in_channels * radix // reduction_factor, 32)
        self.conv = Conv2d(in_channels, channels * radix, 3, 1, 1,
                           groups=groups * radix, bias=False)
        self.bn0 = FrozenBatchNorm(channels * radix)
        self.fc1 = Conv2d(channels, inter, 1, groups=groups)
        self.bn1 = FrozenBatchNorm(inter)
        self.fc2 = Conv2d(inter, channels * radix, 1, groups=groups)

    def forward(self, x):
        r, c, g = self.radix, self.channels, self.groups
        out = F.relu(self.bn0(self.conv(x)))
        b, _, h, w = out.shape
        splits = out.view(b, r, c, h, w)
        gap = splits.sum(1).mean(dim=(2, 3), keepdim=True)     # (B, C, 1, 1)
        gap = F.relu(self.bn1(self.fc1(gap)))
        atten = self.fc2(gap).view(b, g, r, c // g)
        # the radix softmax within each group, in fp32
        atten = torch.softmax(atten.float(), dim=2).to(out.dtype)
        atten = atten.transpose(1, 2).reshape(b, r, c, 1, 1)
        return (splits * atten).sum(1)


class SplitBottleneck(nn.Module):
    """A stride-2 block pools before its split-attention conv, which always
    has stride 1."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 4, radix: int = 2):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_planes = planes * 4
        self.stride = stride
        self.conv1 = Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = SplitAttentionConv(width, width, groups, radix)
        self.conv3 = Conv2d(width, out_planes, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_planes)
        self.downsample = nn.Sequential(
            nn.AvgPool2d(stride, stride) if stride > 1 else nn.Identity(),
            Conv2d(in_ch, out_planes, 1, bias=False),
            FrozenBatchNorm(out_planes)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        if self.stride > 1:
            out = F.avg_pool2d(out, 3, self.stride, 1)
        out = self.bn3(self.conv3(self.conv2(out)))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + identity)


@BACKBONES.register_module()
class ResNeSt(nn.Module):
    """Returns the feature maps selected by out_indices. The stem and the
    stages before ``frozen_stages`` run with autograd off (the JAX
    package's ``stop_gradient`` after stage ``frozen_stages - 1``)."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, groups: int = 1,
                 base_width: int = 4, radix: int = 2,
                 stem_channels: int = 64, norm_eval: bool = True,
                 style: str = 'pytorch', norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.num_stages = num_stages
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.stem = make_deep_stem(stem_channels)
        in_ch = stem_channels
        planes = 64
        for s, n_blocks in enumerate(_ARCH[depth][:num_stages]):
            blocks = []
            for b in range(n_blocks):
                blocks.append(SplitBottleneck(
                    in_ch, planes, 2 if (s > 0 and b == 0) else 1,
                    downsample=b == 0, groups=groups, base_width=base_width,
                    radix=radix))
                in_ch = planes * 4
            self.add_module(f'layer{s + 1}', nn.Sequential(*blocks))
            planes *= 2

    def forward(self, x):
        grad = torch.is_grad_enabled()
        with torch.set_grad_enabled(grad and self.frozen_stages < 1):
            x = max_pool_torch(self.stem(x), 3, 2, 1)
        outs = []
        for s in range(self.num_stages):
            with torch.set_grad_enabled(grad and s >= self.frozen_stages):
                x = getattr(self, f'layer{s + 1}')(x)
            if s in self.out_indices:
                outs.append(x)
        return tuple(outs)
