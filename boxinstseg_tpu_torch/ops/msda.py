"""Multi-scale deformable attention sampling of one level: plain PyTorch
versions and the CUDA kernel pair (``csrc/msda.cu``).

Counterpart of ``msda_sample_psum_pm`` in
``boxinstseg_tpu/ops/msda_pallas.py``: ``_sample_flat_pm`` is the forward
and ``_pm_bwd`` the backward.

- value (BH, H, W, C); loc_x, loc_y, weight (BH, P*L) in P-major sample
  order ``n = p*L + q``; the result is (BH, L, C).
- ``x = loc_x*W - 0.5`` and ``y = loc_y*H - 0.5`` (grid_sample,
  align_corners=False). A sample is dropped unless ``floor(x)`` lies in
  [-1, W-1] and ``floor(y)`` in [-1, H-1]; corners outside the map read 0.
- The backward gives d(value), d(loc_x) = W * d(wx), d(loc_y) = H * d(wy)
  and d(weight), all gated by the sample's ``ok``.

On the TPU the d(patch) kernel rounds its update rows to bf16; the port
computes in fp32 throughout.

``msda_sample_psum_pm`` dispatches on the device of ``value``: a CUDA
tensor goes through the kernels (``MSDAFunction``), a CPU tensor through
the plain versions (``PlainMSDAFunction``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._native import check, load_library


# ------------------------------------------------------------ plain version

def _geometry(value, loc_x, loc_y):
    """Corner rows of the zero-padded map, corner weights and ``ok``."""
    bh, h, w, c = value.shape
    x = loc_x * w - 0.5
    y = loc_y * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    ok = (x0 >= -1) & (x0 <= w - 1) & (y0 >= -1) & (y0 <= h - 1)
    # index the map padded by one pixel at (y0 + 1, x0 + 1): corners outside
    # the map read the zero pad, and a clipped (not ok) sample reads any row
    xi = torch.clamp(x0 + 1, 0, w).long()
    yi = torch.clamp(y0 + 1, 0, h).long()
    pw = w + 2
    base = (torch.arange(bh, device=value.device) * ((h + 2) * pw))[:, None]
    i00 = base + yi * pw + xi
    idx = (i00, i00 + 1, i00 + pw, i00 + pw + 1)
    cw = ((1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx)
    return idx, cw, (wx, wy, ok)


def _padded_rows(value):
    bh, h, w, c = value.shape
    return F.pad(value, (0, 0, 1, 1, 1, 1)).reshape(-1, c)


def msda_forward_plain(value, loc_x, loc_y, weight, num_points):
    """(BH, L, C) = sum_p weight * bilinear_sample(value, loc)."""
    bh, _, _, c = value.shape
    s = loc_x.shape[1]
    idx, cw, (_, _, ok) = _geometry(value, loc_x, loc_y)
    flat = _padded_rows(value)
    okw = ok * weight
    out = value.new_zeros((bh, s, c))
    for i, k in zip(idx, cw):
        out = out + flat[i] * (k * okw)[..., None]
    return out.reshape(bh, num_points, s // num_points, c).sum(1)


def msda_backward_plain(value, loc_x, loc_y, weight, grad_out, num_points):
    """(d_value, d_loc_x, d_loc_y, d_weight) of ``msda_forward_plain``."""
    bh, h, w, c = value.shape
    s = loc_x.shape[1]
    idx, cw, (wx, wy, ok) = _geometry(value, loc_x, loc_y)
    flat = _padded_rows(value)
    g = grad_out[:, None].expand(bh, num_points, s // num_points, c
                                 ).reshape(bh, s, c)
    r = [(flat[i] * g).sum(-1) for i in idx]             # corner row-dots
    okf = ok.to(value.dtype)
    okw = okf * weight
    d_weight = okf * (cw[0] * r[0] + cw[1] * r[1] + cw[2] * r[2]
                      + cw[3] * r[3])
    d_wx = okw * ((1 - wy) * (r[1] - r[0]) + wy * (r[3] - r[2]))
    d_wy = okw * ((1 - wx) * (r[2] - r[0]) + wx * (r[3] - r[1]))
    d_flat = torch.zeros_like(flat)
    for i, k in zip(idx, cw):
        d_flat.index_add_(0, i.reshape(-1),
                          ((k * okw)[..., None] * g).reshape(-1, c))
    d_value = d_flat.reshape(bh, h + 2, w + 2, c)[:, 1:-1, 1:-1]
    return d_value, d_wx * w, d_wy * h, d_weight


class PlainMSDAFunction(torch.autograd.Function):
    """Plain forward with the explicit backward of ``_pm_bwd``."""

    @staticmethod
    def forward(ctx, value, loc_x, loc_y, weight, num_points):
        ctx.save_for_backward(value, loc_x, loc_y, weight)
        ctx.num_points = num_points
        return msda_forward_plain(value, loc_x, loc_y, weight, num_points)

    @staticmethod
    def backward(ctx, g):
        grads = msda_backward_plain(*ctx.saved_tensors, g.contiguous(),
                                    ctx.num_points)
        return (*grads, None)


# ------------------------------------------------------------- CUDA kernels

@functools.lru_cache(maxsize=None)
def _lib():
    """Build (first call) and type the C interface of csrc/msda.cu."""
    lib = load_library('msda')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msda_forward.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.msda_forward.restype = i
    lib.msda_backward.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.msda_backward.restype = i
    return lib


def _check_inputs(value, loc_x, loc_y, weight, num_points, grad_out=None):
    named = [('value', value), ('loc_x', loc_x), ('loc_y', loc_y),
             ('weight', weight)]
    if grad_out is not None:
        named.append(('grad_out', grad_out))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f'{name} must be a CUDA tensor')
        if t.device != value.device:
            raise ValueError(f'{name} is on {t.device}, value on '
                             f'{value.device}')
        if t.dtype != torch.float32:
            raise ValueError(f'{name} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if value.dim() != 4:
        raise ValueError(f'value must be (BH, H, W, C), got '
                         f'{tuple(value.shape)}')
    bh = value.shape[0]
    s = loc_x.shape[-1]
    for name, t in named[1:4]:
        if tuple(t.shape) != (bh, s):
            raise ValueError(f'{name} {tuple(t.shape)} != {(bh, s)}')
    if num_points < 1 or s % num_points:
        raise ValueError(f'{s} samples are not P-major over {num_points} '
                         f'points')
    c = value.shape[-1]
    if grad_out is not None and tuple(grad_out.shape) != (
            bh, s // num_points, c):
        raise ValueError(f'grad_out {tuple(grad_out.shape)} != '
                         f'{(bh, s // num_points, c)}')
    if value.numel() >= 2 ** 31 or bh * s >= 2 ** 31:
        raise ValueError('the MSDA kernels index with 32-bit counts')


def msda_forward_cuda(value, loc_x, loc_y, weight, num_points):
    """MSDA forward kernel: (BH, L, C)."""
    _check_inputs(value, loc_x, loc_y, weight, num_points)
    lib = _lib()
    bh, h, w, c = value.shape
    l = loc_x.shape[1] // num_points
    out = torch.empty((bh, l, c), dtype=torch.float32, device=value.device)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    with torch.cuda.device(value.device):
        err = lib.msda_forward(value.data_ptr(), loc_x.data_ptr(),
                               loc_y.data_ptr(), weight.data_ptr(),
                               out.data_ptr(), bh, h, w, c, l, num_points,
                               stream)
    check(err, 'msda_forward')
    msda_forward_cuda.launches += 1
    return out


msda_forward_cuda.launches = 0


def msda_backward_cuda(value, loc_x, loc_y, weight, grad_out, num_points):
    """MSDA backward kernel: (d_value, d_loc_x, d_loc_y, d_weight)."""
    _check_inputs(value, loc_x, loc_y, weight, num_points, grad_out)
    lib = _lib()
    bh, h, w, c = value.shape
    l = loc_x.shape[1] // num_points
    d_value = torch.zeros_like(value)
    d_loc_x = torch.empty_like(loc_x)
    d_loc_y = torch.empty_like(loc_y)
    d_weight = torch.empty_like(weight)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    with torch.cuda.device(value.device):
        err = lib.msda_backward(
            value.data_ptr(), loc_x.data_ptr(), loc_y.data_ptr(),
            weight.data_ptr(), grad_out.data_ptr(), d_value.data_ptr(),
            d_loc_x.data_ptr(), d_loc_y.data_ptr(), d_weight.data_ptr(), bh,
            h, w, c, l, num_points, stream)
    check(err, 'msda_backward')
    msda_backward_cuda.launches += 1
    return d_value, d_loc_x, d_loc_y, d_weight


msda_backward_cuda.launches = 0


class MSDAFunction(torch.autograd.Function):
    """Forward kernel, backward kernel."""

    @staticmethod
    def forward(ctx, value, loc_x, loc_y, weight, num_points):
        ctx.save_for_backward(value, loc_x, loc_y, weight)
        ctx.num_points = num_points
        return msda_forward_cuda(value, loc_x, loc_y, weight, num_points)

    @staticmethod
    def backward(ctx, g):
        grads = msda_backward_cuda(*ctx.saved_tensors, g.contiguous(),
                                   ctx.num_points)
        return (*grads, None)


def msda_sample_psum_pm(value: torch.Tensor, loc_x: torch.Tensor,
                        loc_y: torch.Tensor, weight: torch.Tensor,
                        num_points: int) -> torch.Tensor:
    """Deformable-attention sampling of one level, P-major samples.

    value: (BH, H, W, C); loc_x/loc_y/weight: (BH, P*L) with sample
    n = p*L + q. Returns (BH, L, C) = sum_p weight * bilinear_sample.

    A CUDA tensor launches the kernels (and raises on what they do not
    take); a CPU tensor takes the plain versions."""
    args = (value.contiguous(), loc_x.contiguous(), loc_y.contiguous(),
            weight.contiguous(), num_points)
    if value.is_cuda:
        return MSDAFunction.apply(*args)
    if value.device.type == 'cpu':
        return PlainMSDAFunction.apply(*args)
    raise ValueError(f'no MSDA sampler for device {value.device}')
