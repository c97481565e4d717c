"""Sine positional encoding, counterpart of
``boxinstseg_tpu/models/utils/positional_encoding.py`` (reference:
mmdet/models/utils/positional_encoding.py SinePositionalEncoding).

The encoding is returned channels-last, (B, H, W, 2*num_feats), as the JAX
package returns it: the transformer code flattens it into (B, H*W, C)
tokens.
"""
from __future__ import annotations

import math

import torch


TEMPERATURE = 10000
SCALE = 2 * math.pi
EPS = 1e-6


class SinePositionalEncoding:
    """Sine/cosine embedding of the 1-based pixel coordinates of an
    unpadded (H, W) map, normalised to (0, 2*pi] (the reference's
    ``normalize=True``, the only setting its configs use)."""

    def __init__(self, num_feats: int = 128):
        self.num_feats = num_feats

    def __call__(self, b: int, h: int, w: int, device=None) -> torch.Tensor:
        f32 = dict(dtype=torch.float32, device=device)
        # cumsum over an all-ones (no padding) mask == 1-based coordinates
        y = torch.arange(1, h + 1, **f32)[:, None].expand(h, w)
        x = torch.arange(1, w + 1, **f32)[None, :].expand(h, w)
        y = y / (h + EPS) * SCALE
        x = x / (w + EPS) * SCALE
        dim_t = torch.arange(self.num_feats, **f32)
        dim_t = TEMPERATURE ** (2 * (dim_t // 2) / self.num_feats)
        pos_x = x[..., None] / dim_t
        pos_y = y[..., None] / dim_t
        pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                            dim=-1).reshape(h, w, -1)
        pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                            dim=-1).reshape(h, w, -1)
        pos = torch.cat([pos_y, pos_x], dim=-1)
        return pos[None].expand(b, h, w, pos.shape[-1])
