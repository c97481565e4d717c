"""Frozen copy: the plain version alone, which the public entry at the
end of this file calls. Multi-scale deformable attention sampling: plain PyTorch versions and
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


import torch
import torch.nn.functional as F



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


def ms_deform_attn(value, spatial_shapes, reference_points, offsets, attn):
    """Deformable-attention sampling of one layer, all levels: (B, L,
    heads * D), the plain per-level sampling differentiated by autograd."""
    shapes = tuple((int(hh), int(ww)) for hh, ww in spatial_shapes)
    return ms_deform_attn_plain(value.float(), shapes,
                                reference_points.float(), offsets.float(),
                                attn.float(),
                                sample=msda_forward_plain).to(value.dtype)
