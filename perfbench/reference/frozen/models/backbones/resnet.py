"""ResNet, ResNeXt and ResNetV1d backbones (NCHW, frozen BN), counterpart
of ``boxinstseg_tpu/models/backbones/resnet.py``.

torchvision / mmdet module layout (``conv1``, ``bn1``, ``layer{i}.{b}``,
``downsample.0/1``), 'pytorch' style (stride on the 3x3 conv),
``frozen_stages`` and ``norm_eval`` (every BN frozen). The V1d options
take mmdet's names too: ``deep_stem`` is ``stem.{0,1,3,4,6,7}`` (three 3x3
conv / BN pairs, ``stem_channels`` wide), and ``avg_down`` puts an average
pool (``ceil_mode``, padding not counted) before the shortcut's 1x1 conv,
``downsample.{1,2}``, the pool sitting at index 0.

Frozen stages run with autograd off, the counterpart of the JAX package's
``stop_gradient``: their parameters get no gradient from the loss. The
train step gives them zero gradients so that SGD's weight decay still
moves them, as optax does for every parameter (see ``engine.train_state``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d, FrozenBatchNorm, max_pool_torch
from ...registry import BACKBONES

_ARCH = {
    18: ('basic', (2, 2, 2, 2)),
    34: ('basic', (3, 4, 6, 3)),
    50: ('bottleneck', (3, 4, 6, 3)),
    101: ('bottleneck', (3, 4, 23, 3)),
    152: ('bottleneck', (3, 8, 36, 3)),
}


def avg_pool_ceil(stride: int) -> nn.Module:
    """The V1d shortcut's pool: ``AvgPool2d(stride, stride, ceil_mode=True,
    count_include_pad=False)``, the JAX package's ``_avg_pool_ceil``; the
    identity at stride 1, where the JAX package does not pool."""
    if stride == 1:
        return nn.Identity()
    return nn.AvgPool2d(stride, stride, ceil_mode=True,
                        count_include_pad=False)


def _downsample(in_ch: int, out_ch: int, stride: int,
                avg_down: bool = False) -> nn.Sequential:
    if avg_down:
        return nn.Sequential(avg_pool_ceil(stride),
                             Conv2d(in_ch, out_ch, 1, 1, 0, bias=False),
                             FrozenBatchNorm(out_ch))
    return nn.Sequential(Conv2d(in_ch, out_ch, 1, stride, 0, bias=False),
                         FrozenBatchNorm(out_ch))


def make_deep_stem(channels: int) -> nn.Sequential:
    """Three 3x3 conv / frozen BN / ReLU stages, the first of stride 2, to
    ``channels // 2``, ``channels // 2`` and ``channels`` (mmdet's
    ``stem``)."""
    layers, cin = [], 3
    for cout, stride in ((channels // 2, 2), (channels // 2, 1),
                         (channels, 1)):
        layers += [Conv2d(cin, cout, 3, stride, 1, bias=False),
                   FrozenBatchNorm(cout), nn.ReLU()]
        cin = cout
    return nn.Sequential(*layers)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, avg_down: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = _downsample(in_ch, planes, stride, avg_down) \
            if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, avg_down: bool = False,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_planes = planes * 4
        self.conv1 = Conv2d(in_ch, width, 1, 1, 0, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        # 'pytorch' style: stride on the 3x3 conv
        self.conv2 = Conv2d(width, width, 3, stride, 1, groups=groups,
                            bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = Conv2d(width, out_planes, 1, 1, 0, bias=False)
        self.bn3 = FrozenBatchNorm(out_planes)
        self.downsample = _downsample(in_ch, out_planes, stride, avg_down) \
            if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + identity)


@BACKBONES.register_module()
class ResNet(nn.Module):
    """Returns the feature maps selected by out_indices (0->C2 ... 3->C5)."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, groups: int = 1,
                 base_width: int = 64, norm_eval: bool = True,
                 style: str = 'pytorch', zero_init_residual: bool = False,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None, deep_stem: bool = False,
                 avg_down: bool = False, stem_channels: int = 64):
        super().__init__()
        if style != 'pytorch':
            raise ValueError(f'unsupported ResNet style {style!r}')
        block_type, stage_blocks = _ARCH[depth]
        block_cls = Bottleneck if block_type == 'bottleneck' else BasicBlock
        self.num_stages = num_stages
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.deep_stem = deep_stem
        if deep_stem:
            self.stem = make_deep_stem(stem_channels)
            in_ch = stem_channels
        else:   # the plain stem is 64 wide whatever stem_channels says
            self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = FrozenBatchNorm(64)
            in_ch = 64
        for stage_idx in range(num_stages):
            planes = 64 * (2 ** stage_idx)
            stride = 1 if stage_idx == 0 else 2
            blocks = []
            for b in range(stage_blocks[stage_idx]):
                kw = ({'groups': groups, 'base_width': base_width}
                      if block_type == 'bottleneck' else {})
                down = b == 0 and (stride != 1 or
                                   planes * block_cls.expansion != in_ch)
                blocks.append(block_cls(in_ch, planes,
                                        stride if b == 0 else 1, down,
                                        avg_down, **kw))
                in_ch = planes * block_cls.expansion
            self.add_module(f'layer{stage_idx + 1}', nn.Sequential(*blocks))

    def forward(self, x):
        grad = torch.is_grad_enabled()
        with torch.set_grad_enabled(grad and self.frozen_stages < 0):
            x = self.stem(x) if self.deep_stem \
                else F.relu(self.bn1(self.conv1(x)))
            x = max_pool_torch(x, 3, 2, 1)
        outs = []
        for stage_idx in range(self.num_stages):
            frozen = self.frozen_stages >= stage_idx + 1
            with torch.set_grad_enabled(grad and not frozen):
                x = getattr(self, f'layer{stage_idx + 1}')(x)
            if stage_idx in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class ResNeXt(ResNet):
    """ResNet with grouped bottlenecks, 32x4d by default."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kwargs):
        super().__init__(groups=groups, base_width=base_width, **kwargs)


@BACKBONES.register_module()
class ResNetV1d(ResNet):
    """ResNet with the deep stem and the average-pool shortcut."""

    def __init__(self, deep_stem: bool = True, avg_down: bool = True,
                 **kwargs):
        super().__init__(deep_stem=deep_stem, avg_down=avg_down, **kwargs)
