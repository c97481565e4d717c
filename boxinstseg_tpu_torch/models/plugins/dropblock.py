"""DropBlock regularisation, counterpart of
``boxinstseg_tpu/models/plugins/dropblock.py`` (reference:
mmdet/models/plugins/dropblock.py): Bernoulli seeds on the valid interior,
dilated by a block_size x block_size max pool, the kept values rescaled
by the kept fraction; gamma warms up linearly over ``warmup_iters``.

The draw is split from what follows it: ``forward`` takes the seed map as
``seeds`` (B, C, H - bs + 1, W - bs + 1), or draws it from ``generator``;
``block_mask`` and ``apply_seeds`` are the rest. The iteration is passed
in, as in the JAX package (the reference keeps a Python counter). NCHW.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

_EPS = 1e-6


class DropBlock(nn.Module):

    def __init__(self, drop_prob: float = 0.1, block_size: int = 3,
                 warmup_iters: int = 2000):
        super().__init__()
        assert block_size % 2 == 1
        self.drop_prob = drop_prob
        self.block_size = block_size
        self.warmup_iters = warmup_iters

    def gamma(self, h: int, w: int, iteration=None):
        """The seed rate of an (h, w) map at ``iteration``."""
        bs = self.block_size
        gamma = (self.drop_prob * h * w) / ((h - bs + 1) * (w - bs + 1)
                                            * bs ** 2)
        if iteration is not None and self.warmup_iters > 0:
            gamma = gamma * torch.clamp(torch.as_tensor(
                iteration, dtype=torch.float32) / self.warmup_iters, max=1.0)
        return gamma

    def block_mask(self, seeds: torch.Tensor) -> torch.Tensor:
        """1 - the seeds dilated to blocks, at the padded map's size."""
        pad = self.block_size // 2
        seeds = F.pad(seeds, (pad, pad, pad, pad))
        dropped = F.max_pool2d(seeds, self.block_size, stride=1,
                               padding=pad)
        return 1.0 - dropped

    def apply_seeds(self, x: torch.Tensor, seeds: torch.Tensor
                    ) -> torch.Tensor:
        mask = self.block_mask(seeds.to(x.dtype))
        return x * mask * (mask.numel() / (_EPS + mask.sum()))

    def forward(self, x: torch.Tensor, iteration=None,
                generator: Optional[torch.Generator] = None,
                seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, C, H, W); identity in eval mode."""
        if not self.training:
            return x
        b, c, h, w = x.shape
        if seeds is None:
            bs = self.block_size
            gamma = torch.as_tensor(self.gamma(h, w, iteration))
            gdev = generator.device if generator is not None else x.device
            u = torch.rand((b, c, h - bs + 1, w - bs + 1),
                           generator=generator, device=gdev)
            seeds = (u < gamma.to(gdev)).to(x.device)
        return self.apply_seeds(x, seeds)
