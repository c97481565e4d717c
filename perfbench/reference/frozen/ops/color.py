"""Colour-space math for BoxInst's pairwise affinity (NCHW).

sRGB -> CIELab is closed form so it stays on the device, and the
dilated-neighbourhood colour similarity is computed per offset with
shifted slices instead of an unfold tensor (reference:
condinst_head.py:190-246, 1413-1416).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

# D65/2deg reference white used by skimage's default rgb2lab.
_XN, _YN, _ZN = 0.95047, 1.0, 1.08883

_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)


def srgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """Convert (B, 3, H, W) sRGB in [0, 1] to CIELab (D65), as
    skimage.color.rgb2lab (inverse gamma, XYZ matrix, cube-root branch)."""
    rgb = rgb.float()
    linear = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                         rgb / 12.92)
    m = torch.tensor(_RGB2XYZ, dtype=torch.float32, device=rgb.device)
    xyz = torch.einsum('oc,bchw->bohw', m, linear)
    white = torch.tensor((_XN, _YN, _ZN), dtype=torch.float32,
                         device=rgb.device)
    xyz = xyz / white[None, :, None, None]

    eps = 0.008856451679035631  # (6/29)**3
    kappa = 7.787037037037035   # (29/6)**2 / 3
    f = torch.where(xyz > eps, xyz.clamp(min=0) ** (1.0 / 3.0),
                    kappa * xyz + 16.0 / 116.0)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([L, a, b], dim=1)


def srgb_uint8_to_lab(rgb_255: torch.Tensor) -> torch.Tensor:
    """Images are truncated to uint8 before rgb2lab (the reference calls
    ``.byte()`` on the avg-pooled image, condinst_head.py:1413)."""
    rgb = torch.clamp(torch.floor(rgb_255), 0.0, 255.0) / 255.0
    return srgb_to_lab(rgb)


def neighbor_offsets(kernel_size: int, dilation: int
                     ) -> List[Tuple[int, int]]:
    """The K^2-1 (dy, dx) offsets of ``unfold_wo_center`` in row-major
    order (reference: condinst_head.py:190-224). The pairwise kernels index
    the colour gates by this order."""
    half = kernel_size // 2
    offsets = []
    for ky in range(-half, half + 1):
        for kx in range(-half, half + 1):
            if ky == 0 and kx == 0:
                continue
            offsets.append((ky * dilation, kx * dilation))
    return offsets


def shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """value[..., p] = x[..., p + (dy, dx)] over the two trailing axes,
    zero outside."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    y0, x0 = max(dy, 0), max(dx, 0)
    return xp[..., y0:y0 + h, x0:x0 + w]


def image_color_similarity(lab: torch.Tensor, valid_mask: torch.Tensor,
                           kernel_size: int = 3, dilation: int = 2
                           ) -> torch.Tensor:
    """Per-offset Lab colour similarity, masked by neighbour validity.

    Args:
      lab: (B, 3, H, W) CIELab image.
      valid_mask: (B, H, W) 1.0 inside the un-padded image region.
    Returns:
      (B, K^2-1, H, W): exp(-||lab[p] - lab[p+o]|| * 0.5) * valid[p+o]
      (reference: get_image_color_similarity, condinst_head.py:227-246).
    """
    sims = []
    for dy, dx in neighbor_offsets(kernel_size, dilation):
        nb = shift2d(lab, dy, dx)
        dist = torch.sqrt(((lab - nb) ** 2).sum(dim=1))
        sims.append(torch.exp(-dist * 0.5) * shift2d(valid_mask, dy, dx))
    return torch.stack(sims, dim=1)
