"""Resizing ops (NCHW: spatial axes trailing) with the reference's exact
interpolation math, counterpart of ``boxinstseg_tpu/ops/upsample.py``.

``aligned_bilinear`` reproduces the AdelaiDet-style upsample (reference:
condinst_head.py:146-167): replicate-pad by one on the bottom/right,
bilinear resize with align_corners=True to ``factor*h+1`` x ``factor*w+1``,
replicate-pad the top/left by ``factor//2`` and crop. Along each axis that
is a fixed (shift, weight) lerp per output phase.
"""
from __future__ import annotations

import torch


def _aligned_axis_phases(factor: int):
    """Per output phase ph: position ``factor*q + ph`` reads
    ``(1-w)*x[q+s] + w*x[q+s+1]`` with (s, w) constant per phase."""
    half = factor // 2
    phases = []
    for ph in range(factor):
        s, rem = divmod(ph - half, factor)
        phases.append((s, rem / float(factor)))
    return phases


def _phase_upsample_axis(x: torch.Tensor, dim: int, phases) -> torch.Tensor:
    """Upsample one axis by len(phases) with replicate edges."""
    n = x.shape[dim]
    xp = torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim)
    outs = []
    for s, wgt in phases:
        lo = xp.narrow(dim, 1 + s, n)
        if wgt == 0.0:
            outs.append(lo)
        else:
            hi = xp.narrow(dim, 2 + s, n)
            outs.append((1.0 - wgt) * lo + wgt * hi)
    y = torch.stack(outs, dim=dim + 1)
    shape = list(x.shape)
    shape[dim] = n * len(phases)
    return y.reshape(shape)


def aligned_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Upsample (..., H, W) by an integer factor, AdelaiDet-aligned."""
    assert factor >= 1 and isinstance(factor, int)
    if factor == 1:
        return x
    phases = _aligned_axis_phases(factor)
    x = _phase_upsample_axis(x, x.dim() - 2, phases)
    return _phase_upsample_axis(x, x.dim() - 1, phases)


def avg_pool_stride(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Non-overlapping average pool of (..., H, W) with the given stride
    (reference: F.avg_pool2d in condinst_head.py:1400); rows first, then
    columns, then one multiply, as the JAX package sums."""
    if stride == 1:
        return x
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    assert h % stride == 0 and w % stride == 0, (h, w, stride)
    x = x.reshape(lead + (h // stride, stride, w)).sum(-2)
    x = x.reshape(lead + (h // stride, w // stride, stride)).sum(-1)
    return x * (1.0 / (stride * stride))
