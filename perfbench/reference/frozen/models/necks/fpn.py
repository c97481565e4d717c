"""Feature Pyramid Network (NCHW), counterpart of
``boxinstseg_tpu/models/necks/fpn.py`` (reference mmdet/models/necks/fpn.py).

BoxInst layout: start_level=1, num_outs=5, add_extra_convs='on_output',
relu_before_extra_convs=True -> P3..P7; without extra convs the extra
levels are max-pooled (P2..P6 of the SOLO-family configs). The extra convs
sit at the end of ``fpn_convs``, as in the reference checkpoints. The
first of them reads the last used input (``'on_input'``, whose conv takes
that input's channels), the last lateral (``'on_lateral'``) or the last
output (``'on_output'``, and ``True`` as in the JAX package).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ConvModule, max_pool_torch
from ...registry import NECKS


def nearest_upsample_to(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest resize of (..., H, W) to ``hw`` with the integer source
    index (i * in) // out on each axis, the JAX package's formula; float
    scale factors can round to a different source row."""
    h, w = hw
    sh, sw = x.shape[-2:]
    ys = torch.arange(h, device=x.device) * sh // h
    xs = torch.arange(w, device=x.device) * sw // w
    return x.index_select(-2, ys).index_select(-1, xs)


@NECKS.register_module()
class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs=False, relu_before_extra_convs: bool = False,
                 no_norm_on_lateral: bool = False,
                 upsample_cfg: Optional[dict] = None,
                 norm_cfg: Optional[dict] = None,
                 init_cfg: Optional[dict] = None):
        super().__init__()
        if norm_cfg is not None:
            raise ValueError('FPN norm_cfg is not supported')
        if add_extra_convs not in (False, True, 'on_input', 'on_lateral',
                                   'on_output'):
            raise ValueError(f'unknown add_extra_convs {add_extra_convs!r}')
        self.in_channels = list(in_channels)
        end = len(self.in_channels) if end_level in (-1, None) \
            else end_level + 1
        self.used = list(range(start_level, end))
        self.num_outs = num_outs
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        conv = lambda cin, k, s, p: ConvModule(  # noqa: E731
            cin, out_channels, k, s, p, act=None)
        self.lateral_convs = nn.ModuleList(
            conv(self.in_channels[i], 1, 1, 0) for i in self.used)
        self.fpn_convs = nn.ModuleList(
            conv(out_channels, 3, 1, 1) for _ in self.used)
        if add_extra_convs:
            for k in range(num_outs - len(self.used)):
                cin = self.in_channels[self.used[-1]] \
                    if k == 0 and add_extra_convs == 'on_input' \
                    else out_channels
                self.fpn_convs.append(conv(cin, 3, 2, 1))

    def forward(self, inputs):
        assert len(inputs) == len(self.in_channels)
        n = len(self.used)
        laterals = [self.lateral_convs[i](inputs[idx])
                    for i, idx in enumerate(self.used)]
        # top-down pathway
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + nearest_upsample_to(
                laterals[i], laterals[i - 1].shape[-2:])
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n)]

        extra = self.num_outs - n
        if extra > 0:
            if not self.add_extra_convs:
                for _ in range(extra):
                    outs.append(max_pool_torch(outs[-1], 1, 2, 0))
            else:
                src = {'on_input': inputs[self.used[-1]],
                       'on_lateral': laterals[-1]}.get(
                           self.add_extra_convs, outs[-1])
                for k in range(extra):
                    if k > 0 and self.relu_before_extra_convs:
                        src = F.relu(src)
                    src = self.fpn_convs[n + k](src)
                    outs.append(src)
        return tuple(outs)
