"""CARAFE content-aware upsampling (NCHW), counterpart of
``boxinstseg_tpu/ops/carafe.py`` (the reference uses mmcv's CUDA
``CARAFEPack`` in its FPN_CARAFE neck).

out(p') = sum_n W_p'(n) X(floor(p' / s) + n) over the zero-padded
k_up x k_up neighbourhood n of the source pixel, with per-output kernels
predicted from the input: channel compressor (1x1) -> content encoder ->
pixel shuffle -> softmax over the k_up^2 taps.

The port keeps mmcv's channel layout and names (``channel_compressor``,
``content_encoder``): the encoder's channel ``k * s*s + sy * s + sx`` is
tap k of sub-pixel (sy, sx), as ``F.pixel_shuffle`` reads it. The JAX
module reads ``(sy * s + sx) * k_up^2 + k`` instead; ``utils.weights``
permutes the encoder's output channels between the two.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import Conv2d


def carafe_reassemble(x: torch.Tensor, kernels: torch.Tensor, scale: int,
                      k_up: int) -> torch.Tensor:
    """Reassemble ``x`` (B, C, H, W) into (B, C, sH, sW) with per-output
    kernels (B, k_up^2, sH, sW), already normalised: one contraction per
    sub-pixel phase over the unfolded neighbourhoods (B, C, k^2, H, W),
    accumulated in fp32 and returned in x's dtype."""
    b, c, h, w = x.shape
    k2 = k_up * k_up
    nbrs = F.unfold(x, k_up, padding=k_up // 2).view(b, c, k2, h, w)
    kern = kernels.view(b, k2, h, scale, w, scale).permute(0, 3, 5, 1, 2, 4)
    out = torch.einsum('bckhw,byxkhw->bchywx', nbrs.float(), kern.float())
    return out.reshape(b, c, h * scale, w * scale).to(x.dtype)


class CARAFEPack(nn.Module):
    """Kernel prediction and reassembly (mmcv ``CARAFEPack``). Only
    ``up_group=1`` is computed, as in the JAX package; another value
    raises."""

    def __init__(self, channels: int, scale_factor: int = 2,
                 up_kernel: int = 5, up_group: int = 1,
                 encoder_kernel: int = 3, encoder_dilation: int = 1,
                 compressed_channels: int = 64):
        super().__init__()
        if up_group != 1:
            raise ValueError(f'CARAFE up_group={up_group}: only 1 is '
                             f'computed')
        self.scale_factor = scale_factor
        self.up_kernel = up_kernel
        self.channel_compressor = Conv2d(channels, compressed_channels, 1)
        self.content_encoder = Conv2d(
            compressed_channels, scale_factor ** 2 * up_kernel ** 2,
            encoder_kernel, 1,
            (encoder_kernel - 1) // 2 * encoder_dilation, encoder_dilation)

    def forward(self, x):
        enc = self.content_encoder(self.channel_compressor(x))
        kernels = torch.softmax(
            F.pixel_shuffle(enc, self.scale_factor).float(), dim=1)
        return carafe_reassemble(x, kernels.to(x.dtype), self.scale_factor,
                                 self.up_kernel)
