"""Resizing ops (NCHW: spatial axes trailing) with the reference's exact
interpolation math, counterpart of ``boxinstseg_tpu/ops/upsample.py``.

``aligned_bilinear`` reproduces the AdelaiDet-style upsample (reference:
condinst_head.py:146-167): replicate-pad by one on the bottom/right,
bilinear resize with align_corners=True to ``factor*h+1`` x ``factor*w+1``,
replicate-pad the top/left by ``factor//2`` and crop. Along each axis that
is a fixed (shift, weight) lerp per output phase.
"""
from __future__ import annotations

import functools

import numpy as np
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


@functools.lru_cache(maxsize=None)
def _axis_taps(n_in: int, n_out: int, align_corners: bool = False):
    """Two source taps and their weights per output index of a bilinear
    resize, computed in float64 as the JAX package computes its resampling
    matrices. Half-pixel centres: source coordinate (o + 0.5) * n_in /
    n_out - 0.5 clamped to [0, n_in - 1]; ``align_corners``: o * (n_in -
    1) / (n_out - 1)."""
    out = np.arange(n_out, dtype=np.float64)
    if align_corners:
        coords = out * ((n_in - 1) / max(n_out - 1, 1))
    else:
        coords = np.clip((out + 0.5) * (n_in / n_out) - 0.5, 0.0,
                         n_in - 1.0)
    q0 = np.floor(coords).astype(np.int64)
    q1 = np.minimum(q0 + 1, n_in - 1)
    r = coords - q0
    w0 = np.where(q0 == q1, 1.0, 1.0 - r).astype(np.float32)
    w1 = np.where(q0 == q1, 0.0, r).astype(np.float32)
    return q0, q1, w0, w1


def _resize_axis(x: torch.Tensor, n_out: int, dim: int,
                 align_corners: bool = False) -> torch.Tensor:
    n_in = x.shape[dim]
    if n_in == n_out:
        return x
    shape = [1] * x.dim()
    shape[dim] = n_out
    q0, q1, w0, w1 = (torch.from_numpy(a).to(x.device)
                      for a in _axis_taps(n_in, n_out, align_corners))
    return (x.index_select(dim, q0) * w0.to(x.dtype).reshape(shape)
            + x.index_select(dim, q1) * w1.to(x.dtype).reshape(shape))


def interpolate_bilinear(x: torch.Tensor, out_hw,
                         align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (..., H, W) to ``out_hw``, one axis after the
    other: half-pixel centres and clamped source coordinates (F.interpolate's
    bilinear, align_corners=False), or the corner-aligned grid with
    ``align_corners``.

    F.interpolate itself computes the source coordinates in float32; at
    256 -> 96 that moves a result by up to 4e-5 against the JAX package's
    ``interpolate_bilinear``, whose float64 coordinates this function
    shares."""
    x = _resize_axis(x, int(out_hw[0]), x.dim() - 2, align_corners)
    return _resize_axis(x, int(out_hw[1]), x.dim() - 1, align_corners)


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
