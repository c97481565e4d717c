"""Local Consistency Module refinement: plain PyTorch versions and the CUDA
kernel pair (``csrc/lcm.cu``).

Counterpart of the refinement in ``LocalConsistencyModule``
(``boxinstseg_tpu/models/losses/levelset_loss.py``): ``num_iter`` rounds of

    st[p] <- sum_k aff[b, k, p] * st[clip(p + off_k)]

over every (H, W) plane of phi, with replicate (clamped) edges. The
refinement is linear in phi, so its backward is the adjoint operator run
for the same number of rounds: ``apply_at`` scatters aff * g back to the
clamped neighbour. aff is a constant (the affinity is computed under
no-grad).

``lcm_refine`` calls the registered torch op ``boxinstseg::lcm_forward``
(the offsets flattened to ``[dy0, dx0, dy1, dx1, ...]``), whose gradient in
phi is the op ``boxinstseg::lcm_adjoint``; the dispatcher picks the
implementation by the device of phi: the kernels on a CUDA tensor, the
plain versions (``lcm_forward_plain``, ``lcm_adjoint_plain``) on a CPU
tensor.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from ._native import as_fp32, check, load_library

Offsets = Sequence[Tuple[int, int]]


# ------------------------------------------------------------ plain version

def replicate_shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x[..., clip(p + (dy, dx))]; the spatial axes are the last two."""
    h, w = x.shape[-2:]
    ys = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
    return x[..., ys, :][..., :, xs]


def replicate_shift_adjoint(g: torch.Tensor, dy: int, dx: int
                            ) -> torch.Tensor:
    """Adjoint of ``replicate_shift``: scatter-add g[p] into clip(p + o)."""
    h, w = g.shape[-2:]
    ys = torch.clamp(torch.arange(h, device=g.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=g.device) + dx, 0, w - 1)
    tmp = torch.zeros_like(g).index_add_(g.dim() - 2, ys, g)
    return torch.zeros_like(g).index_add_(g.dim() - 1, xs, tmp)


def apply_a(aff: torch.Tensor, phi: torch.Tensor, offsets: Offsets
            ) -> torch.Tensor:
    """One forward round. aff (B, K, H, W); phi (B, C, H, W)."""
    out = torch.zeros_like(phi)
    for k, (dy, dx) in enumerate(offsets):
        out = out + aff[:, k:k + 1] * replicate_shift(phi, dy, dx)
    return out


def apply_at(aff: torch.Tensor, g: torch.Tensor, offsets: Offsets
             ) -> torch.Tensor:
    """One adjoint round: grad[q] = sum_k sum_{clip(p + off_k) = q}
    aff[k, p] g[p] (edge rows and columns accumulate the clamp)."""
    out = torch.zeros_like(g)
    for k, (dy, dx) in enumerate(offsets):
        out = out + replicate_shift_adjoint(aff[:, k:k + 1] * g, dy, dx)
    return out


def lcm_forward_plain(aff, phi, offsets, num_iter):
    for _ in range(num_iter):
        phi = apply_a(aff, phi, offsets)
    return phi


def lcm_adjoint_plain(aff, g, offsets, num_iter):
    for _ in range(num_iter):
        g = apply_at(aff, g, offsets)
    return g


# ------------------------------------------------------------- CUDA kernels

# dynamic shared memory a block may use on sm_90
MAX_SHARED_BYTES = 232448
# the ring kernel (csrc/lcm.cu): threads a block, main-pass pixels a
# thread, blocks a cluster (the portable cluster size)
RING_THREADS, RING_PPT, RING_MAX_BANDS = 512, 5, 8


def ring_dilation(offsets: Offsets):
    """d when ``offsets`` are the 3x3 ring at dilation d in row-major order
    (``LocalConsistencyModule.offsets``), else None."""
    offsets = [tuple(o) for o in offsets]
    if len(offsets) != 8 or offsets[0][0] >= 0:
        return None
    d = -offsets[0][0]
    ring = [(dy * d, dx * d) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if dy or dx]
    return d if offsets == ring else None


def ring_plan(b: int, c: int, h: int, w: int, offsets: Offsets,
              transpose: bool, max_clusters):
    """How the ring kernel covers a (b, c, h, w) call, or None where it does
    not take it (another offset set, a band over RING_THREADS * RING_PPT
    pixels, more than RING_MAX_BANDS bands, a band under d rows, or no
    channel's two buffers (plus the adjoint's aff) in shared memory).

    Bands are as few as fit. ``max_clusters(d, G, band_rows, bands)`` says
    how many clusters of that shape the card runs at once; the channels of
    an image are split into as many groups as fill that one wave. Returns
    dict(d, G channels a block, band_rows, bands)."""
    d = ring_dilation(offsets)
    rows_cap = RING_THREADS * RING_PPT // w
    if d is None or rows_cap < 1:
        return None
    band_rows = -(-h // -(-h // rows_cap))
    bands = -(-h // band_rows)
    if bands > RING_MAX_BANDS or (bands > 1 and band_rows < d):
        return None
    plane = (band_rows + 2 * d) * w * 4
    g_max = (MAX_SHARED_BYTES - (8 * plane if transpose else 0)) \
        // (2 * plane)
    if g_max < 1:
        return None
    wave = max_clusters(d, g_max, band_rows, bands)
    g = min(g_max, -(-c // max(1, wave // b)))
    if b > 65535 or -(-c // g) > 65535:
        return None
    return dict(d=d, G=g, band_rows=band_rows, bands=bands)


@functools.lru_cache(maxsize=None)
def _ring_clusters(index: int, transpose: bool, c: int, h: int, w: int,
                   d: int, g: int, band_rows: int, bands: int) -> int:
    """Clusters of a ring call that device ``index`` runs at once."""
    with torch.cuda.device(index):
        n = _lib().lcm_ring_clusters(int(transpose), c, h, w, d, g,
                                     band_rows, bands)
    check(max(-n, 0), 'lcm_ring_clusters')
    return n


@functools.lru_cache(maxsize=None)
def _lib():
    """Build (first call) and type the C interface of csrc/lcm.cu."""
    lib = load_library('lcm')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lcm_ring.argtypes = [i] + [p] * 3 + [i] * 9 + [p]
    lib.lcm_ring.restype = i
    lib.lcm_generic.argtypes = [i] + [p] * 3 + [i] * 5 + [p, p, i, p]
    lib.lcm_generic.restype = i
    lib.lcm_ring_clusters.argtypes = [i] * 8
    lib.lcm_ring_clusters.restype = i
    return lib


def _check_inputs(aff, phi, offsets):
    for name, t in (('aff', aff), ('phi', phi)):
        if not t.is_cuda:
            raise ValueError(f'{name} must be a CUDA tensor')
        if t.device != phi.device:
            raise ValueError(f'{name} is on {t.device}, phi on {phi.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    _check_layout(aff, phi, offsets)


def _check_layout(aff, phi, offsets):
    """The shapes and types the ops take; no device or stride check, so it
    also runs on fake tensors."""
    for name, t in (('aff', aff), ('phi', phi)):
        if t.dtype != torch.float32:
            raise ValueError(f'{name} must be float32, got {t.dtype}')
    if phi.dim() != 4:
        raise ValueError(f'phi must be (B, C, H, W), got {tuple(phi.shape)}')
    b, _, h, w = phi.shape
    if tuple(aff.shape) != (b, len(offsets), h, w):
        raise ValueError(f'aff {tuple(aff.shape)} != '
                         f'{(b, len(offsets), h, w)}')
    if not 1 <= len(offsets) <= 16:
        raise ValueError(f'{len(offsets)} offsets: the kernels take 1-16')
    if phi.numel() >= 2 ** 31:
        raise ValueError('the LCM kernels index with 32-bit counts')


def launch_plan(phi, offsets, transpose):
    """The ring kernel's plan for phi (B, C, H, W) on its card (``ring_plan``
    with the card's cluster occupancy), or None for the generic kernel."""
    b, c, h, w = phi.shape
    return ring_plan(b, c, h, w, offsets, transpose, functools.partial(
        _ring_clusters, phi.device.index, transpose, c, h, w))


def _launch(transpose, name, aff, phi, offsets, num_iter):
    """The ring kernel where ``ring_plan`` takes the call, else the generic
    kernel (one block a plane, two fp32 copies of it in shared memory)."""
    _check_inputs(aff, phi, offsets)
    b, c, h, w = phi.shape
    out = torch.empty_like(phi)
    stream = torch.cuda.current_stream(phi.device).cuda_stream
    plan = launch_plan(phi, offsets, transpose)
    if plan is None and 2 * h * w * 4 > MAX_SHARED_BYTES:
        raise ValueError(
            f'a {h}x{w} plane with offsets {list(offsets)}: the ring kernel '
            f'takes the 3x3 ring in bands of at most '
            f'{RING_THREADS * RING_PPT} pixels, at most {RING_MAX_BANDS} '
            f'bands; the generic kernel\'s two fp32 copies of a plane in '
            f'shared memory take H * W <= {MAX_SHARED_BYTES // 8}')
    with torch.cuda.device(phi.device):
        if plan is not None:
            err = _lib().lcm_ring(
                int(transpose), aff.data_ptr(), phi.data_ptr(),
                out.data_ptr(), b, c, h, w, plan['d'], plan['G'],
                plan['band_rows'], plan['bands'], int(num_iter), stream)
        else:
            k = len(offsets)
            dy = (ctypes.c_int * k)(*[int(o[0]) for o in offsets])
            dx = (ctypes.c_int * k)(*[int(o[1]) for o in offsets])
            err = _lib().lcm_generic(
                int(transpose), aff.data_ptr(), phi.data_ptr(),
                out.data_ptr(), b, c, h, w, k, dy, dx, int(num_iter), stream)
    check(err, name)
    return out


def lcm_forward_cuda(aff, phi, offsets, num_iter):
    """LCM forward kernel: ``num_iter`` refinement rounds of phi."""
    out = _launch(False, 'lcm_forward', aff, phi, offsets, num_iter)
    lcm_forward_cuda.launches += 1
    return out


lcm_forward_cuda.launches = 0


def lcm_adjoint_cuda(aff, g, offsets, num_iter):
    """LCM adjoint kernel: ``num_iter`` transposed rounds of g."""
    out = _launch(True, 'lcm_adjoint', aff, g, offsets, num_iter)
    lcm_adjoint_cuda.launches += 1
    return out


lcm_adjoint_cuda.launches = 0


# --------------------------------------------------- registered torch ops

def _pairs(flat: List[int]) -> Tuple[Tuple[int, int], ...]:
    """[dy0, dx0, dy1, dx1, ...] -> ((dy0, dx0), (dy1, dx1), ...)."""
    if len(flat) % 2:
        raise ValueError(f'offsets {flat}: not (dy, dx) pairs')
    return tuple((int(flat[i]), int(flat[i + 1]))
                 for i in range(0, len(flat), 2))


@torch.library.custom_op('boxinstseg::lcm_forward', mutates_args=(),
                         device_types='cuda')
def lcm_forward_op(aff: torch.Tensor, phi: torch.Tensor, offsets: List[int],
                   num_iter: int) -> torch.Tensor:
    """K3 as a torch op: ``num_iter`` rounds of phi (B, C, H, W) with the
    constant affinities aff (B, K, H, W); ``offsets`` flat (dy, dx)
    pairs."""
    return lcm_forward_cuda(aff, phi, _pairs(offsets), num_iter)


@lcm_forward_op.register_kernel('cpu')
def _lcm_forward_cpu(aff, phi, offsets, num_iter):
    _check_layout(aff, phi, _pairs(offsets))
    return lcm_forward_plain(aff, phi, _pairs(offsets), num_iter)


@lcm_forward_op.register_fake
def _lcm_forward_fake(aff, phi, offsets, num_iter):
    _check_layout(aff, phi, _pairs(offsets))
    return torch.empty_like(phi)


@torch.library.custom_op('boxinstseg::lcm_adjoint', mutates_args=(),
                         device_types='cuda')
def lcm_adjoint_op(aff: torch.Tensor, g: torch.Tensor, offsets: List[int],
                   num_iter: int) -> torch.Tensor:
    """K3's adjoint as a torch op: ``num_iter`` transposed rounds of g."""
    return lcm_adjoint_cuda(aff, g, _pairs(offsets), num_iter)


@lcm_adjoint_op.register_kernel('cpu')
def _lcm_adjoint_cpu(aff, g, offsets, num_iter):
    _check_layout(aff, g, _pairs(offsets))
    return lcm_adjoint_plain(aff, g, _pairs(offsets), num_iter)


@lcm_adjoint_op.register_fake
def _lcm_adjoint_fake(aff, g, offsets, num_iter):
    _check_layout(aff, g, _pairs(offsets))
    return torch.empty_like(g)


def _lcm_setup_context(ctx, inputs, output):
    aff, phi, offsets, num_iter = inputs
    ctx.save_for_backward(aff)
    ctx.cfg = (offsets, num_iter)


def _lcm_backward_formula(ctx, grad):
    """The gradient in phi is the adjoint op; aff is a constant."""
    aff, = ctx.saved_tensors
    return None, lcm_adjoint_op(aff, grad.contiguous(), *ctx.cfg), None, None


lcm_forward_op.register_autograd(_lcm_backward_formula,
                                 setup_context=_lcm_setup_context)


def _lcm_flops(aff_shape, phi_shape, offsets, num_iter, out_shape=None,
               **kwargs) -> int:
    """A multiply-add per pixel, channel, offset and round."""
    n = 1
    for k in phi_shape:
        n *= k
    return 2 * n * (len(offsets) // 2) * num_iter


register_flop_formula(torch.ops.boxinstseg.lcm_forward)(_lcm_flops)
register_flop_formula(torch.ops.boxinstseg.lcm_adjoint)(_lcm_flops)


def lcm_refine(aff: torch.Tensor, phi: torch.Tensor, offsets: Offsets,
               num_iter: int) -> torch.Tensor:
    """``num_iter`` LCM rounds of phi (B, C, H, W) with affinities aff
    (B, K, H, W), differentiable in phi (aff is detached).

    Calls the op ``boxinstseg::lcm_forward``: the kernels for CUDA tensors
    (which raise on what they do not take), the plain versions for CPU
    tensors. The kernels take fp32 (as the JAX wrapper casts): a bf16 or
    fp16 phi, as autocast leaves it, runs in fp32 and comes back in its
    own dtype, and so does its gradient."""
    if phi.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'no LCM refinement for device {phi.device}')
    flat = [int(v) for o in offsets for v in o]
    return lcm_forward_op(as_fp32(aff.detach()).contiguous(),
                          as_fp32(phi).contiguous(), flat,
                          int(num_iter)).to(phi.dtype)
