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

``lcm_refine`` dispatches on the device of ``phi``: a CUDA tensor goes
through the kernels (``LCMRefineFunction``), a CPU tensor through the plain
versions (``PlainLCMRefineFunction``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from ._native import check, load_library

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


class PlainLCMRefineFunction(torch.autograd.Function):
    """Plain forward rounds; the backward runs the adjoint rounds."""

    @staticmethod
    def forward(ctx, aff, phi, offsets, num_iter):
        ctx.save_for_backward(aff)
        ctx.cfg = (tuple(offsets), num_iter)
        return lcm_forward_plain(aff, phi, offsets, num_iter)

    @staticmethod
    def backward(ctx, g):
        aff, = ctx.saved_tensors
        return None, lcm_adjoint_plain(aff, g, *ctx.cfg), None, None


# ------------------------------------------------------------- CUDA kernels

# dynamic shared memory a block may use on sm_90 (two fp32 planes)
MAX_SHARED_BYTES = 232448


@functools.lru_cache(maxsize=None)
def _lib():
    """Build (first call) and type the C interface of csrc/lcm.cu."""
    lib = load_library('lcm')
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.lcm_forward, lib.lcm_adjoint):
        fn.argtypes = [p] * 3 + [i] * 5 + [p, p, i, p]
        fn.restype = i
    return lib


def _check_inputs(aff, phi, offsets):
    for name, t in (('aff', aff), ('phi', phi)):
        if not t.is_cuda:
            raise ValueError(f'{name} must be a CUDA tensor')
        if t.device != phi.device:
            raise ValueError(f'{name} is on {t.device}, phi on {phi.device}')
        if t.dtype != torch.float32:
            raise ValueError(f'{name} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if phi.dim() != 4:
        raise ValueError(f'phi must be (B, C, H, W), got {tuple(phi.shape)}')
    b, _, h, w = phi.shape
    if tuple(aff.shape) != (b, len(offsets), h, w):
        raise ValueError(f'aff {tuple(aff.shape)} != '
                         f'{(b, len(offsets), h, w)}')
    if not 1 <= len(offsets) <= 16:
        raise ValueError(f'{len(offsets)} offsets: the kernels take 1-16')
    if 2 * h * w * 4 > MAX_SHARED_BYTES:
        raise ValueError(f'a {h}x{w} plane does not fit twice in shared '
                         f'memory')
    if phi.numel() >= 2 ** 31:
        raise ValueError('the LCM kernels index with 32-bit counts')


def _launch(fn, name, aff, phi, offsets, num_iter):
    _check_inputs(aff, phi, offsets)
    b, c, h, w = phi.shape
    k = len(offsets)
    dy = (ctypes.c_int * k)(*[int(o[0]) for o in offsets])
    dx = (ctypes.c_int * k)(*[int(o[1]) for o in offsets])
    out = torch.empty_like(phi)
    stream = torch.cuda.current_stream(phi.device).cuda_stream
    with torch.cuda.device(phi.device):
        err = fn(aff.data_ptr(), phi.data_ptr(), out.data_ptr(), b, c, h, w,
                 k, dy, dx, int(num_iter), stream)
    check(err, name)
    return out


def lcm_forward_cuda(aff, phi, offsets, num_iter):
    """LCM forward kernel: ``num_iter`` refinement rounds of phi."""
    out = _launch(_lib().lcm_forward, 'lcm_forward', aff, phi, offsets,
                  num_iter)
    lcm_forward_cuda.launches += 1
    return out


lcm_forward_cuda.launches = 0


def lcm_adjoint_cuda(aff, g, offsets, num_iter):
    """LCM adjoint kernel: ``num_iter`` transposed rounds of g."""
    out = _launch(_lib().lcm_adjoint, 'lcm_adjoint', aff, g, offsets,
                  num_iter)
    lcm_adjoint_cuda.launches += 1
    return out


lcm_adjoint_cuda.launches = 0


class LCMRefineFunction(torch.autograd.Function):
    """Forward kernel; the backward is the adjoint kernel."""

    @staticmethod
    def forward(ctx, aff, phi, offsets, num_iter):
        ctx.save_for_backward(aff)
        ctx.cfg = (tuple(offsets), num_iter)
        return lcm_forward_cuda(aff, phi, offsets, num_iter)

    @staticmethod
    def backward(ctx, g):
        aff, = ctx.saved_tensors
        return None, lcm_adjoint_cuda(aff, g.contiguous(), *ctx.cfg), \
            None, None


def lcm_refine(aff: torch.Tensor, phi: torch.Tensor, offsets: Offsets,
               num_iter: int) -> torch.Tensor:
    """``num_iter`` LCM rounds of phi (B, C, H, W) with affinities aff
    (B, K, H, W), differentiable in phi.

    A CUDA tensor launches the kernels (and raises on what they do not
    take); a CPU tensor takes the plain versions."""
    args = (aff.detach().contiguous(), phi.contiguous(),
            tuple(tuple(o) for o in offsets), num_iter)
    if phi.is_cuda:
        return LCMRefineFunction.apply(*args)
    if phi.device.type == 'cpu':
        return PlainLCMRefineFunction.apply(*args)
    raise ValueError(f'no LCM refinement for device {phi.device}')
