"""DetectoRS ResNet backbone (NCHW, frozen BN), counterpart of
``boxinstseg_tpu/models/backbones/detectors_resnet.py``: a ResNet whose
bottleneck 3x3 is a Switchable Atrous Convolution (SAConv), and whose
first block of each stage can take a Recursive Feature Pyramid feature
through a zero-initialised ``rfp_conv``.

As in the JAX package (ROADMAP D14), every stage gets SAConvs whatever
``stage_with_sac`` says, and ``sac`` is accepted but not read, except
that ``sac.use_deform=True`` raises: the deformable SAConv is not
computed. The SAConv's parameters are the JAX module's (``weight``,
``weight_diff``, ``switch``, ``pre_context``, ``post_context``); mmcv's
``SAConv2d`` also holds ``weight_gamma`` / ``weight_beta`` and pads its
switch's pool by reflection, so an mmdet DetectoRS checkpoint does not
load.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d, FrozenBatchNorm, max_pool_torch
from ...registry import BACKBONES

_ARCH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class SAConv(nn.Module):
    """Switchable Atrous Convolution: one weight-standardised 3x3 kernel
    at dilation 1 and, plus a learned delta, at dilation 3, blended per
    pixel by a sigmoid switch on a 5x5 average (zero padding counted),
    between two global-context 1x1 convs."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.pre_context = Conv2d(in_channels, in_channels, 1)
        self.switch = Conv2d(in_channels, 1, 1, stride)
        nn.init.ones_(self.switch.bias)
        self.weight = nn.Parameter(torch.empty(channels, in_channels, 3, 3))
        nn.init.kaiming_normal_(self.weight, nonlinearity='relu')
        self.weight_diff = nn.Parameter(torch.zeros(channels, in_channels,
                                                    3, 3))
        self.post_context = Conv2d(channels, channels, 1)

    def forward(self, x):
        x = x + self.pre_context(x.mean(dim=(2, 3), keepdim=True))
        switch = self.switch(F.avg_pool2d(x, 5, 1, 2))
        switch = torch.sigmoid(switch.float()).to(x.dtype)
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        std = torch.sqrt(w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
                         + 1e-5)
        w_std = ((w - mean) / std).to(x.dtype)
        out_s = F.conv2d(x, w_std, None, self.stride, 1, 1)
        out_l = F.conv2d(x, w_std + self.weight_diff.to(x.dtype), None,
                         self.stride, 3, 3)
        out = switch * out_s + (1.0 - switch) * out_l
        return out + self.post_context(out.mean(dim=(2, 3), keepdim=True))


class SACBottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 rfp_inplanes: Optional[int] = None):
        super().__init__()
        out_planes = planes * 4
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = SAConv(planes, planes, stride)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv2d(planes, out_planes, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_planes)
        self.downsample = nn.Sequential(
            Conv2d(in_ch, out_planes, 1, stride, bias=False),
            FrozenBatchNorm(out_planes)) if downsample else None
        self.rfp_conv = None
        if rfp_inplanes:
            self.rfp_conv = nn.Conv2d(rfp_inplanes, out_planes, 1)
            nn.init.zeros_(self.rfp_conv.weight)
            nn.init.zeros_(self.rfp_conv.bias)

    def forward(self, x, rfp_feat=None):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample(x) if self.downsample is not None else x
        out = F.relu(out + identity)
        if self.rfp_conv is not None and rfp_feat is not None:
            out = out + self.rfp_conv(rfp_feat)
        return out


@BACKBONES.register_module()
class DetectoRS_ResNet(nn.Module):
    """The 7x7 stem, then SAC bottlenecks. ``forward(x, rfp_feats)``
    passes ``rfp_feats[s]`` to the first block of stage s; with
    ``output_img`` the input image leads the outputs. The stem and the
    stages before ``frozen_stages`` run with autograd off."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, sac: Optional[dict] = None,
                 stage_with_sac: Sequence[bool] = (False, True, True, True),
                 rfp_inplanes: Optional[int] = None,
                 output_img: bool = False, norm_eval: bool = True,
                 style: str = 'pytorch', norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        if sac and sac.get('use_deform', False):
            raise ValueError('sac.use_deform=True: the deformable SAConv is '
                             'not computed by the JAX package either')
        self.num_stages = num_stages
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.output_img = output_img
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_ch, planes = 64, 64
        for s, n_blocks in enumerate(_ARCH[depth][:num_stages]):
            blocks = []
            for b in range(n_blocks):
                blocks.append(SACBottleneck(
                    in_ch, planes, 2 if (s > 0 and b == 0) else 1,
                    downsample=b == 0,
                    rfp_inplanes=rfp_inplanes if b == 0 else None))
                in_ch = planes * 4
            self.add_module(f'layer{s + 1}', nn.ModuleList(blocks))
            planes *= 2

    def forward(self, x, rfp_feats=None):
        img = x
        grad = torch.is_grad_enabled()
        with torch.set_grad_enabled(grad and self.frozen_stages < 1):
            x = max_pool_torch(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = [img] if self.output_img else []
        for s in range(self.num_stages):
            rfp = None if rfp_feats is None else rfp_feats[s]
            with torch.set_grad_enabled(grad and s >= self.frozen_stages):
                for b, block in enumerate(getattr(self, f'layer{s + 1}')):
                    x = block(x, rfp if b == 0 else None)
            if s in self.out_indices:
                outs.append(x)
        return tuple(outs)
