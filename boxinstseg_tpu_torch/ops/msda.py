"""Multi-scale deformable attention sampling: plain PyTorch versions and
the CUDA kernel pair (``csrc/msda.cu``), one launch per encoder layer.

``ms_deform_attn(value, spatial_shapes, reference_points, offsets, attn)``
is the sampling core of ``MultiScaleDeformableAttention`` for all levels
at once, in the module's own layouts (no permute or copy around the call):

- value (B, S, heads, D), the levels' maps concatenated row-major;
- reference_points (B, L, 2), normalised xy shared by the levels, a
  constant (no gradient is returned for it: it must not require grad);
- offsets (B, L, heads, levels, P, 2), ``sampling_offsets``' output;
- attn (B, L, heads, levels, P), after the softmax;
- the result is (B, L, heads * D), the sum over levels in level order of
  ``msda_sample_psum_pm`` at ``lx = ref_x + off_x / w``,
  ``ly = ref_y + off_y / h``.

``msda_sample_psum_pm`` is the per-level primitive, counterpart of
``msda_sample_psum_pm`` in ``boxinstseg_tpu/ops/msda_pallas.py``
(``_sample_flat_pm`` is the forward and ``_pm_bwd`` the backward):

- value (BH, H, W, C); loc_x, loc_y, weight (BH, P*L) in P-major sample
  order ``n = p*L + q``; the result is (BH, L, C).
- ``x = loc_x*W - 0.5`` and ``y = loc_y*H - 0.5`` (grid_sample,
  align_corners=False). A sample is dropped unless ``floor(x)`` lies in
  [-1, W-1] and ``floor(y)`` in [-1, H-1]; corners outside the map read 0.
- The backward gives d(value), d(loc_x) = W * d(wx), d(loc_y) = H * d(wy)
  and d(weight), all gated by the sample's ``ok``.

It has plain versions only; the kernels take a whole layer. On the TPU the
d(patch) kernel rounds its update rows to bf16; the port computes in fp32
throughout.

``ms_deform_attn`` calls the registered torch op ``boxinstseg::msda_forward``
(``torch.library.custom_op``; the layer's level shapes as a flat
``[h0, w0, h1, w1, ...]``), whose implementation the dispatcher picks by
the device of the inputs: on a CUDA tensor the kernel, on a CPU tensor
``ms_deform_attn_plain``, the loop over the levels of the per-level plain
versions. Its gradient is the op ``boxinstseg::msda_backward`` (the
backward kernel; ``ms_deform_attn_backward_plain`` on the CPU). A fake
implementation gives each op's output shapes from its inputs' shapes, so
that ``torch.export`` and ``FlopCounterMode`` trace through it; the flop
formulas count 8 operations a channel a sample forward and 16 backward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ._native import as_fp32, check, load_library


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


def ms_deform_attn_plain(value, spatial_shapes, reference_points, offsets,
                         attn, sample=PlainMSDAFunction.apply):
    """The plain version of ``ms_deform_attn``: a loop over the levels of
    ``sample`` (the per-level plain forward with its explicit backward;
    ``msda_forward_plain`` gives autograd through the plain forward)."""
    b, _, h, d = value.shape
    l = reference_points.shape[1]
    npnt = attn.shape[-1]
    ref_x = reference_points[:, None, None, :, 0]          # (b,1,1,l)
    ref_y = reference_points[:, None, None, :, 1]

    def p_major(t):
        """(b, l, h, p) -> (b*h, p*l) with sample n = p*l + q."""
        return t.permute(0, 2, 3, 1).reshape(b * h, npnt * l)

    out = value.new_zeros((b, l, h, d))
    start = 0
    for lvl, (hh, ww) in enumerate(spatial_shapes):
        vl = value[:, start:start + hh * ww].reshape(b, hh, ww, h, d)
        vl = vl.permute(0, 3, 1, 2, 4).reshape(b * h, hh, ww, d)
        start += hh * ww
        off = offsets[:, :, :, lvl].permute(0, 2, 3, 1, 4)  # (b,h,p,l,2)
        lx = (ref_x + off[..., 0] / ww).reshape(b * h, npnt * l)
        ly = (ref_y + off[..., 1] / hh).reshape(b * h, npnt * l)
        smp = sample(vl, lx, ly, p_major(attn[:, :, :, lvl]), npnt)
        out = out + smp.reshape(b, h, l, d).transpose(1, 2)
    return out.reshape(b, l, h * d)


# ------------------------------------------------------------- CUDA kernels

@functools.lru_cache(maxsize=None)
def _lib():
    """Build (first call) and type the C interface of csrc/msda.cu."""
    lib = load_library('msda')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msda_forward.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.msda_forward.restype = i
    lib.msda_backward.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.msda_backward.restype = i
    return lib


def check_layer_inputs(value, spatial_shapes, reference_points, offsets,
                       attn, grad_out=None):
    """Raise on what ``ms_deform_attn`` does not take; return the level
    shapes as a tuple of (h, w) ints."""
    named = [('value', value), ('reference_points', reference_points),
             ('offsets', offsets), ('attn', attn)]
    if grad_out is not None:
        named.append(('grad_out', grad_out))
    for name, t in named:
        if t.device != value.device:
            raise ValueError(f'{name} is on {t.device}, value on '
                             f'{value.device}')
        if t.dtype != torch.float32:
            raise ValueError(f'{name} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if reference_points.requires_grad:
        raise ValueError('reference_points must not require grad: no '
                         'gradient is returned for them')
    if value.dim() != 4:
        raise ValueError(f'value must be (B, S, heads, D), got '
                         f'{tuple(value.shape)}')
    b, s, h, d = value.shape
    shapes = tuple((int(hh), int(ww)) for hh, ww in spatial_shapes)
    if not shapes or min(min(sh) for sh in shapes) < 1 or \
            sum(hh * ww for hh, ww in shapes) != s:
        raise ValueError(f'spatial_shapes {shapes} do not tile the {s} '
                         f'positions of value')
    if reference_points.dim() != 3 or reference_points.shape[0] != b \
            or reference_points.shape[2] != 2:
        raise ValueError(f'reference_points must be (B, L, 2), got '
                         f'{tuple(reference_points.shape)}')
    l, nl = reference_points.shape[1], len(shapes)
    if offsets.dim() != 6 or tuple(offsets.shape[:4]) != (b, l, h, nl) \
            or offsets.shape[5] != 2:
        raise ValueError(f'offsets must be {(b, l, h, nl)} + (P, 2), got '
                         f'{tuple(offsets.shape)}')
    want = (b, l, h, nl, offsets.shape[4])
    if tuple(attn.shape) != want:
        raise ValueError(f'attn {tuple(attn.shape)} != {want}')
    if grad_out is not None and tuple(grad_out.shape) != (b, l, h * d):
        raise ValueError(f'grad_out {tuple(grad_out.shape)} != '
                         f'{(b, l, h * d)}')
    return shapes


def _check_cuda(*tensors):
    for t in tensors:
        if not t.is_cuda:
            raise ValueError('the MSDA kernels take CUDA tensors')
        if t.data_ptr() % 16:
            raise ValueError('the MSDA kernels read 16-byte aligned rows')


def _shapes_arg(shapes):
    flat = [n for sh in shapes for n in sh]
    return (ctypes.c_int * len(flat))(*flat)


def msda_forward_cuda(value, spatial_shapes, reference_points, offsets,
                      attn):
    """MSDA forward kernel of one layer: (B, L, heads * D)."""
    shapes = check_layer_inputs(value, spatial_shapes, reference_points,
                                offsets, attn)
    _check_cuda(value, reference_points, offsets, attn)
    lib = _lib()
    b, s, h, d = value.shape
    l, p = reference_points.shape[1], attn.shape[-1]
    out = torch.empty((b, l, h * d), dtype=torch.float32, device=value.device)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    with torch.cuda.device(value.device):
        err = lib.msda_forward(
            value.data_ptr(), reference_points.data_ptr(),
            offsets.data_ptr(), attn.data_ptr(), out.data_ptr(),
            _shapes_arg(shapes), len(shapes), b, s, l, h, d, p, stream)
    check(err, 'msda_forward')
    msda_forward_cuda.launches += 1
    return out


msda_forward_cuda.launches = 0


def msda_backward_cuda(value, spatial_shapes, reference_points, offsets,
                       attn, grad_out):
    """MSDA backward kernel of one layer: (d_value, d_offsets, d_attn)."""
    shapes = check_layer_inputs(value, spatial_shapes, reference_points,
                                offsets, attn, grad_out)
    _check_cuda(value, reference_points, offsets, attn, grad_out)
    lib = _lib()
    b, s, h, d = value.shape
    l, p = reference_points.shape[1], attn.shape[-1]
    d_value = torch.zeros_like(value)
    d_offsets = torch.empty_like(offsets)
    d_attn = torch.empty_like(attn)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    with torch.cuda.device(value.device):
        err = lib.msda_backward(
            value.data_ptr(), reference_points.data_ptr(),
            offsets.data_ptr(), attn.data_ptr(), grad_out.data_ptr(),
            d_value.data_ptr(), d_offsets.data_ptr(), d_attn.data_ptr(),
            _shapes_arg(shapes), len(shapes), b, s, l, h, d, p, stream)
    check(err, 'msda_backward')
    msda_backward_cuda.launches += 1
    return d_value, d_offsets, d_attn


msda_backward_cuda.launches = 0


# --------------------------------------------------- registered torch ops

def _pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """The op schema's flat ``[h0, w0, h1, w1, ...]`` as (h, w) pairs."""
    return tuple((int(flat[i]), int(flat[i + 1]))
                 for i in range(0, len(flat), 2))


def ms_deform_attn_backward_plain(value, spatial_shapes, reference_points,
                                  offsets, attn, grad_out):
    """(d_value, d_offsets, d_attn) of ``ms_deform_attn_plain``: the
    per-level ``msda_backward_plain``, its location gradients taken back
    through ``loc = ref + offset / size``."""
    b, s, h, d = value.shape
    l, npnt = reference_points.shape[1], attn.shape[-1]
    ref_x = reference_points[:, None, None, :, 0]
    ref_y = reference_points[:, None, None, :, 1]
    g = grad_out.reshape(b, l, h, d).transpose(1, 2).reshape(b * h, l, d)
    d_value, d_offsets = [], torch.empty_like(offsets)
    d_attn = torch.empty_like(attn)

    def back(t):
        """(b*h, p*l) -> (b, l, h, p), the inverse of the P-major order."""
        return t.reshape(b, h, npnt, l).permute(0, 3, 1, 2)

    start = 0
    for lvl, (hh, ww) in enumerate(spatial_shapes):
        vl = value[:, start:start + hh * ww].reshape(b, hh, ww, h, d)
        vl = vl.permute(0, 3, 1, 2, 4).reshape(b * h, hh, ww, d)
        start += hh * ww
        off = offsets[:, :, :, lvl].permute(0, 2, 3, 1, 4)
        lx = (ref_x + off[..., 0] / ww).reshape(b * h, npnt * l)
        ly = (ref_y + off[..., 1] / hh).reshape(b * h, npnt * l)
        weight = attn[:, :, :, lvl].permute(0, 2, 3, 1).reshape(
            b * h, npnt * l)
        dv, dlx, dly, dw = msda_backward_plain(vl, lx, ly, weight, g, npnt)
        d_value.append(dv.reshape(b, h, hh * ww, d).transpose(1, 2))
        d_offsets[:, :, :, lvl, :, 0] = back(dlx) / ww
        d_offsets[:, :, :, lvl, :, 1] = back(dly) / hh
        d_attn[:, :, :, lvl] = back(dw)
    return torch.cat(d_value, 1).contiguous(), d_offsets, d_attn


def _check_op_inputs(value, spatial_shapes, reference_points, offsets, attn,
                     grad_out=None):
    """``check_layer_inputs`` on the op's flat shapes; shapes, strides and
    types only, so it also runs on fake tensors."""
    return check_layer_inputs(value, _pairs(spatial_shapes),
                              reference_points, offsets, attn, grad_out)


@torch.library.custom_op('boxinstseg::msda_forward', mutates_args=(),
                         device_types='cuda')
def msda_forward(value: torch.Tensor, spatial_shapes: List[int],
                 reference_points: torch.Tensor, offsets: torch.Tensor,
                 attn: torch.Tensor) -> torch.Tensor:
    """MSDA forward of one layer as a torch op: the kernel on the card."""
    return msda_forward_cuda(value, _pairs(spatial_shapes), reference_points,
                             offsets, attn)


@msda_forward.register_kernel('cpu')
def _msda_forward_cpu(value, spatial_shapes, reference_points, offsets,
                      attn):
    shapes = _check_op_inputs(value, spatial_shapes, reference_points,
                              offsets, attn)
    return ms_deform_attn_plain(value, shapes, reference_points, offsets,
                                attn, sample=msda_forward_plain)


@msda_forward.register_fake
def _msda_forward_fake(value, spatial_shapes, reference_points, offsets,
                       attn):
    _check_op_inputs(value, spatial_shapes, reference_points, offsets, attn)
    b, _, h, d = value.shape
    return value.new_empty((b, reference_points.shape[1], h * d))


@torch.library.custom_op('boxinstseg::msda_backward', mutates_args=(),
                         device_types='cuda')
def msda_backward(value: torch.Tensor, spatial_shapes: List[int],
                  reference_points: torch.Tensor, offsets: torch.Tensor,
                  attn: torch.Tensor, grad_out: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MSDA backward of one layer as a torch op: (d_value, d_offsets,
    d_attn), the kernel on the card."""
    return msda_backward_cuda(value, _pairs(spatial_shapes),
                              reference_points, offsets, attn, grad_out)


@msda_backward.register_kernel('cpu')
def _msda_backward_cpu(value, spatial_shapes, reference_points, offsets,
                       attn, grad_out):
    shapes = _check_op_inputs(value, spatial_shapes, reference_points,
                              offsets, attn, grad_out)
    return ms_deform_attn_backward_plain(value, shapes, reference_points,
                                         offsets, attn, grad_out)


@msda_backward.register_fake
def _msda_backward_fake(value, spatial_shapes, reference_points, offsets,
                        attn, grad_out):
    _check_op_inputs(value, spatial_shapes, reference_points, offsets, attn,
                     grad_out)
    return (torch.empty_like(value), torch.empty_like(offsets),
            torch.empty_like(attn))


def _msda_setup_context(ctx, inputs, output):
    value, spatial_shapes, reference_points, offsets, attn = inputs
    ctx.save_for_backward(value, reference_points, offsets, attn)
    ctx.spatial_shapes = spatial_shapes


def _msda_backward_formula(ctx, grad):
    value, reference_points, offsets, attn = ctx.saved_tensors
    d_value, d_offsets, d_attn = msda_backward(
        value, ctx.spatial_shapes, reference_points, offsets, attn,
        grad.contiguous())
    return d_value, None, None, d_offsets, d_attn


msda_forward.register_autograd(_msda_backward_formula,
                               setup_context=_msda_setup_context)


def _samples(attn_shape) -> int:
    n = 1
    for k in attn_shape:
        n *= k
    return n


@register_flop_formula(torch.ops.boxinstseg.msda_forward)
def _msda_forward_flops(value_shape, spatial_shapes, reference_points_shape,
                        offsets_shape, attn_shape, out_shape=None,
                        **kwargs) -> int:
    """Four corners times a multiply-add a channel, a sample."""
    return 8 * value_shape[3] * _samples(attn_shape)


@register_flop_formula(torch.ops.boxinstseg.msda_backward)
def _msda_backward_flops(value_shape, spatial_shapes, reference_points_shape,
                         offsets_shape, attn_shape, grad_out_shape,
                         out_shape=None, **kwargs) -> int:
    """The corner row-dots and the d(value) updates: twice the forward."""
    return 16 * value_shape[3] * _samples(attn_shape)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   reference_points: torch.Tensor, offsets: torch.Tensor,
                   attn: torch.Tensor) -> torch.Tensor:
    """Deformable-attention sampling of one layer, all levels: (B, L,
    heads * D). See the module docstring for the layouts.

    Calls the op ``boxinstseg::msda_forward``: the kernel pair for CUDA
    tensors (which raises on what it does not take), the plain versions for
    CPU tensors. The kernels take fp32: bf16 or fp16 inputs, as autocast
    leaves them, run in fp32 and the output comes back in value's dtype,
    each gradient in its input's."""
    dtype = value.dtype
    value, reference_points, offsets, attn = (
        as_fp32(t) for t in (value, reference_points, offsets, attn))
    shapes = check_layer_inputs(value, spatial_shapes, reference_points,
                                offsets, attn)
    if value.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'no MSDA sampler for device {value.device}')
    return msda_forward(value, [n for sh in shapes for n in sh],
                        reference_points, offsets, attn).to(dtype)


def msda_sample_psum_pm(value: torch.Tensor, loc_x: torch.Tensor,
                        loc_y: torch.Tensor, weight: torch.Tensor,
                        num_points: int) -> torch.Tensor:
    """Deformable-attention sampling of one level, P-major samples.

    value: (BH, H, W, C); loc_x/loc_y/weight: (BH, P*L) with sample
    n = p*L + q. Returns (BH, L, C) = sum_p weight * bilinear_sample.

    The plain version, for CPU tensors; the kernels take a whole layer, so
    a CUDA tensor raises (call ``ms_deform_attn``)."""
    if value.device.type != 'cpu':
        raise ValueError(f'msda_sample_psum_pm runs on the CPU only; on '
                         f'{value.device} call ms_deform_attn with the '
                         f'layer\'s inputs')
    return PlainMSDAFunction.apply(value.contiguous(), loc_x.contiguous(),
                                   loc_y.contiguous(), weight.contiguous(),
                                   num_points)
