"""PAFPN, ChannelMapper and FPN_CARAFE necks (NCHW), counterparts of
``boxinstseg_tpu/models/necks/pafpn.py``, with mmdet's module names
(``lateral_convs``, ``fpn_convs`` with the extra convs at its end,
``downsample_convs``, ``pafpn_convs``; ``convs`` and ``extra_convs``;
``upsample_modules``).

Where the JAX necks depart from mmdet's, the port follows them:

- PAFPN's ``add_extra_convs='on_lateral'`` takes the last output, as
  ``'on_output'`` does (ROADMAP D15);
- ChannelMapper has no activation unless ``act_cfg`` is given;
- FPN_CARAFE pools its extra levels, crops each 2x upsample to the odd
  lateral below it, and raises on ``norm_cfg`` / ``act_cfg``, which the
  JAX neck accepts and does not read (D15).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn
import torch.nn.functional as F

from ..layers import ConvModule, max_pool_torch
from .fpn import nearest_upsample_to
from ...ops.carafe import CARAFEPack
from ...registry import NECKS


def _used_levels(n_in: int, start_level: int, end_level: int):
    end = n_in if end_level in (-1, None) else end_level + 1
    return list(range(start_level, end))


def _conv(cin: int, cout: int, k: int, s: int = 1) -> ConvModule:
    return ConvModule(cin, cout, k, s, (k - 1) // 2, act=None)


@NECKS.register_module()
class PAFPN(nn.Module):
    """FPN, then a bottom-up path: each level adds the stride-2 conv of the
    level below, then its own 3x3 conv (the lowest level is the FPN's)."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs=False, relu_before_extra_convs: bool = False,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        if norm_cfg is not None:
            raise ValueError('PAFPN norm_cfg is not supported')
        self.in_channels = list(in_channels)
        self.used = _used_levels(len(in_channels), start_level, end_level)
        self.num_outs = num_outs
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        n = len(self.used)
        self.lateral_convs = nn.ModuleList(
            _conv(self.in_channels[i], out_channels, 1) for i in self.used)
        self.fpn_convs = nn.ModuleList(
            _conv(out_channels, out_channels, 3) for _ in self.used)
        self.downsample_convs = nn.ModuleList(
            _conv(out_channels, out_channels, 3, 2) for _ in range(n - 1))
        self.pafpn_convs = nn.ModuleList(
            _conv(out_channels, out_channels, 3) for _ in range(n - 1))
        if add_extra_convs:
            for k in range(num_outs - n):
                cin = self.in_channels[self.used[-1]] \
                    if k == 0 and add_extra_convs == 'on_input' \
                    else out_channels
                self.fpn_convs.append(_conv(cin, out_channels, 3, 2))

    def forward(self, inputs):
        assert len(inputs) == len(self.in_channels)
        n = len(self.used)
        laterals = [conv(inputs[i])
                    for conv, i in zip(self.lateral_convs, self.used)]
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + nearest_upsample_to(
                laterals[i], laterals[i - 1].shape[-2:])
        inter = [self.fpn_convs[i](laterals[i]) for i in range(n)]
        for i in range(n - 1):
            inter[i + 1] = inter[i + 1] + self.downsample_convs[i](inter[i])
        outs = [inter[0]] + [conv(inter[i + 1])
                             for i, conv in enumerate(self.pafpn_convs)]
        extra = self.num_outs - n
        if extra > 0:
            if not self.add_extra_convs:
                for _ in range(extra):
                    outs.append(max_pool_torch(outs[-1], 1, 2, 0))
            else:
                src = inputs[self.used[-1]] \
                    if self.add_extra_convs == 'on_input' else outs[-1]
                for k in range(extra):
                    if k > 0 and self.relu_before_extra_convs:
                        src = F.relu(src)
                    src = self.fpn_convs[n + k](src)
                    outs.append(src)
        return tuple(outs)


@NECKS.register_module()
class ChannelMapper(nn.Module):
    """One ConvModule per level to ``out_channels``, then strided 3x3
    ConvModules on the last input up to ``num_outs`` levels."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, kernel_size: int = 3,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 num_outs: Optional[int] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        self.in_channels = list(in_channels)
        act = 'relu' if act_cfg else None
        self.convs = nn.ModuleList(
            ConvModule(c, out_channels, kernel_size, 1,
                       (kernel_size - 1) // 2, norm_cfg=norm_cfg, act=act)
            for c in in_channels)
        self.extra_convs = nn.ModuleList(
            ConvModule(in_channels[-1] if k == 0 else out_channels,
                       out_channels, 3, 2, 1, norm_cfg=norm_cfg, act=act)
            for k in range((num_outs or len(in_channels)) - len(in_channels)))

    def forward(self, inputs):
        assert len(inputs) == len(self.in_channels)
        outs = [conv(x) for conv, x in zip(self.convs, inputs)]
        src = inputs[-1]
        for conv in self.extra_convs:
            src = conv(src)
            outs.append(src)
        return tuple(outs)


@NECKS.register_module()
class FPN_CARAFE(nn.Module):
    """FPN whose top-down 2x upsampling is CARAFE (``upsample_modules[i -
    1]`` upsamples lateral i); the extra levels are max-pooled."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1,
                 norm_cfg: Optional[dict] = None,
                 act_cfg: Optional[dict] = None,
                 order: tuple = ('conv', 'norm', 'act'),
                 upsample_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        if norm_cfg is not None or act_cfg is not None:
            raise ValueError('FPN_CARAFE norm_cfg / act_cfg are not read by '
                             'the JAX neck and not supported here')
        up = dict(upsample_cfg or dict(type='carafe', up_kernel=5,
                                       up_group=1, encoder_kernel=3,
                                       encoder_dilation=1))
        self.in_channels = list(in_channels)
        self.used = _used_levels(len(in_channels), start_level, end_level)
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            _conv(self.in_channels[i], out_channels, 1) for i in self.used)
        self.upsample_modules = nn.ModuleList(
            CARAFEPack(out_channels, 2, up.get('up_kernel', 5),
                       up.get('up_group', 1), up.get('encoder_kernel', 3),
                       up.get('encoder_dilation', 1))
            for _ in self.used[1:])
        self.fpn_convs = nn.ModuleList(
            _conv(out_channels, out_channels, 3) for _ in self.used)

    def forward(self, inputs):
        assert len(inputs) == len(self.in_channels)
        laterals = [conv(inputs[i])
                    for conv, i in zip(self.lateral_convs, self.used)]
        for i in range(len(laterals) - 1, 0, -1):
            th, tw = laterals[i - 1].shape[-2:]
            laterals[i - 1] = laterals[i - 1] + self.upsample_modules[i - 1](
                laterals[i])[..., :th, :tw]
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        for _ in range(self.num_outs - len(outs)):
            outs.append(max_pool_torch(outs[-1], 1, 2, 0))
        return tuple(outs)
