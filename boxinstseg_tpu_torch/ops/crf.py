"""Binary mean-field CRF fixed point of the DiscoBox pseudo-labels: the plain
PyTorch version and the CUDA kernel (``csrc/crf.cu``).

Counterpart of ``crf_mean_field_pallas`` (``boxinstseg_tpu/ops/
pallas_kernels.py``) and of the branch of ``MeanFieldCRF.__call__`` without
inter-image priors: ``num_iter`` rounds of

    st <- targets AND (sum_o kern[o] * shift_o(st) > thresh)

with the 9 offsets of a 3x3 stencil in row-major order from (-1, -1) and
zero padding. The result is a pseudo-label: no gradient flows through it.

``crf_mean_field`` calls the registered torch op
``boxinstseg::crf_mean_field``, whose implementation the dispatcher picks
by the device of ``bin0``: the kernel on a CUDA tensor (which raises on
what it does not take), ``crf_mean_field_plain`` on a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ._native import as_fp32, check, load_library
from ..utils.profiling import count

# the 3x3 stencil, row-major from (-1, -1): the JAX package's order
OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def stencil_sum(st: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """sum_o kern[:, o] * shift_o(st) for st (B, K, H, W) and kern
    (B, 9, H, W): one zero pad, then the 9 slices in the JAX order, summed
    from 0."""
    h, w = st.shape[-2:]
    pad = F.pad(st, (1, 1, 1, 1))
    s = torch.zeros_like(st)
    for o, (dy, dx) in enumerate(OFFSETS):
        s = s + pad[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w] \
            * kern[:, None, o]
    return s


@functools.lru_cache(maxsize=None)
def _in_bounds(h: int, w: int, offsets) -> np.ndarray:
    """(O, H, W): 1 where the offset's neighbour lies inside the map."""
    m = np.zeros((len(offsets), h, w), np.float32)
    for o, (dy, dx) in enumerate(offsets):
        m[o, max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = 1.0
    return m


def kernel_sum(kern: torch.Tensor, offsets=OFFSETS) -> torch.Tensor:
    """sum_o kern[:, o] * in_bounds_o, (B, H, W), summed from 0 in the
    offsets' order as the JAX package sums it; half of it is the fixed
    point's threshold."""
    inb = torch.from_numpy(_in_bounds(kern.shape[-2], kern.shape[-1],
                                      tuple(offsets))).to(kern.device)
    kv = 0.0
    for o in range(len(offsets)):
        kv = kv + kern[:, o] * inb[o]
    return kv


def crf_mean_field_plain(kern: torch.Tensor, thresh: torch.Tensor,
                         bin0: torch.Tensor, targets: torch.Tensor,
                         num_iter: int) -> torch.Tensor:
    """kern (B, 9, H, W); thresh (B, H, W); bin0 and targets (B, K, H, W),
    binary. Each round pads the state once, sums the 9 slices times their
    kernel planes in the JAX order from 0, compares with thresh and ANDs
    with the targets."""
    keep_in = targets > 0
    thr = thresh[:, None]
    st = bin0
    for _ in range(num_iter):
        st = ((stencil_sum(st, kern) > thr) & keep_in).to(bin0.dtype)
    return st


# dynamic shared memory a block may use on sm_90
MAX_SHARED_BYTES = 232448
# planes a byte, and blocks a cluster (the portable cluster size), of the
# kernel (csrc/crf.cu)
CRF_PLANES, CRF_MAX_BANDS = 8, 8


def band_bytes(rows: int, w: int) -> int:
    """Shared memory of a band of ``rows`` rows: the two state buffers with
    a zero border, the target bits and the flags, a byte a pixel each."""
    return 2 * (rows + 2) * (w + 2) + 2 * rows * w


def crf_plan(b: int, k: int, h: int, w: int, max_clusters):
    """The kernel's bands for a (b, k, h, w) call: the most bands (so the
    most blocks) for which the card runs all ``b * ceil(k / 8)`` plane
    groups in one wave, ``max_clusters(band_rows, bands)`` saying how many
    clusters of that shape run at once; the fewest that fit shared memory
    where no count makes one wave. Returns dict(band_rows, bands), or None
    where more than CRF_MAX_BANDS bands would be needed."""
    rows_cap = 0
    while rows_cap < h and band_bytes(rows_cap + 1, w) <= MAX_SHARED_BYTES:
        rows_cap += 1
    if rows_cap == 0 or -(-h // rows_cap) > CRF_MAX_BANDS:
        return None
    groups = b * -(-k // CRF_PLANES)
    plans = []
    for n in range(-(-h // rows_cap), min(CRF_MAX_BANDS, h) + 1):
        band_rows = -(-h // n)
        plans.append(dict(band_rows=band_rows, bands=-(-h // band_rows)))
    fit = [p for p in plans
           if groups <= max_clusters(p['band_rows'], p['bands'])]
    return fit[-1] if fit else plans[0]


@functools.lru_cache(maxsize=None)
def _clusters(index: int, h: int, w: int, band_rows: int, bands: int) -> int:
    """Clusters of a call's shape that device ``index`` runs at once."""
    with torch.cuda.device(index):
        n = _lib().crf_mean_field_clusters(h, w, band_rows, bands)
    check(max(-n, 0), 'crf_mean_field_clusters')
    return n


@functools.lru_cache(maxsize=None)
def _lib():
    """Build (first call) and type the C interface of csrc/crf.cu."""
    lib = load_library('crf')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crf_mean_field.argtypes = [p] * 5 + [i] * 8 + [p]
    lib.crf_mean_field.restype = i
    lib.crf_mean_field_clusters.argtypes = [i] * 4
    lib.crf_mean_field_clusters.restype = i
    return lib


def _check_inputs(kern, thresh, bin0, targets, kernel_size):
    _check_kernel_size(kernel_size)
    for name, t in (('kern', kern), ('thresh', thresh), ('bin0', bin0),
                    ('targets', targets)):
        if not t.is_cuda:
            raise ValueError(f'{name} must be a CUDA tensor')
        if t.device != bin0.device:
            raise ValueError(f'{name} is on {t.device}, bin0 on '
                             f'{bin0.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    _check_layout(kern, thresh, bin0, targets)


def _check_kernel_size(kernel_size):
    if kernel_size != 3:
        raise ValueError(f'kernel size {kernel_size}: the CRF takes the 3x3 '
                         f'stencil only')


def _check_layout(kern, thresh, bin0, targets):
    """The shapes and types the op takes; no device or stride check, so it
    also runs on fake tensors."""
    for name, t in (('kern', kern), ('thresh', thresh), ('bin0', bin0),
                    ('targets', targets)):
        if t.dtype != torch.float32:
            raise ValueError(f'{name} must be float32, got {t.dtype}')
    if bin0.dim() != 4 or targets.shape != bin0.shape:
        raise ValueError(f'bin0 {tuple(bin0.shape)} and targets '
                         f'{tuple(targets.shape)} must be one (B, K, H, W)')
    b, _, h, w = bin0.shape
    if tuple(kern.shape) != (b, len(OFFSETS), h, w):
        raise ValueError(f'kern {tuple(kern.shape)} != '
                         f'{(b, len(OFFSETS), h, w)}')
    if tuple(thresh.shape) != (b, h, w):
        raise ValueError(f'thresh {tuple(thresh.shape)} != {(b, h, w)}')
    if b > 65535 or -(-bin0.shape[1] // CRF_PLANES) > 65535:
        raise ValueError('too many images or planes for one launch')


def launch_plan(bin0):
    """The kernel's bands for bin0 (B, K, H, W) on its card (``crf_plan``
    with the card's cluster occupancy)."""
    b, k, h, w = bin0.shape
    return crf_plan(b, k, h, w, functools.partial(
        _clusters, bin0.device.index, h, w))


def crf_mean_field_cuda(kern, thresh, bin0, targets, num_iter,
                        kernel_size=3):
    """K7 kernel: ``num_iter`` rounds of the binary fixed point (fp32
    inputs; bin0 is read as bin0 != 0)."""
    _check_inputs(kern, thresh, bin0, targets, kernel_size)
    b, k, h, w = bin0.shape
    plan = launch_plan(bin0)
    if plan is None:
        raise ValueError(
            f'a {h}x{w} plane: the CRF kernel takes at most {CRF_MAX_BANDS} '
            f'bands of rows, each within {MAX_SHARED_BYTES} bytes of shared '
            f'memory (2 (rows + 2)(W + 2) + 2 rows W)')
    out = torch.empty_like(bin0)
    vec4 = w % 4 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (bin0, targets, out))
    stream = torch.cuda.current_stream(bin0.device).cuda_stream
    with torch.cuda.device(bin0.device):
        err = _lib().crf_mean_field(
            kern.data_ptr(), thresh.data_ptr(), bin0.data_ptr(),
            targets.data_ptr(), out.data_ptr(), b, k, h, w,
            plan['band_rows'], plan['bands'], int(vec4), int(num_iter),
            stream)
    check(err, 'crf_mean_field')
    count('kernel.crf_mean_field')
    return out


# --------------------------------------------------- registered torch op

@torch.library.custom_op('boxinstseg::crf_mean_field', mutates_args=(),
                         device_types='cuda')
def crf_mean_field_op(kern: torch.Tensor, thresh: torch.Tensor,
                      bin0: torch.Tensor, targets: torch.Tensor,
                      num_iter: int, kernel_size: int) -> torch.Tensor:
    """K7 as a torch op: the fixed point after ``num_iter`` rounds (fp32;
    no gradient: a pseudo-label)."""
    return crf_mean_field_cuda(kern, thresh, bin0, targets, num_iter,
                               kernel_size)


@crf_mean_field_op.register_kernel('cpu')
def _crf_mean_field_cpu(kern, thresh, bin0, targets, num_iter, kernel_size):
    _check_kernel_size(kernel_size)
    _check_layout(kern, thresh, bin0, targets)
    return crf_mean_field_plain(kern, thresh, bin0, targets, num_iter)


@crf_mean_field_op.register_fake
def _crf_mean_field_fake(kern, thresh, bin0, targets, num_iter,
                         kernel_size):
    _check_kernel_size(kernel_size)
    _check_layout(kern, thresh, bin0, targets)
    return torch.empty_like(bin0)


@register_flop_formula(torch.ops.boxinstseg.crf_mean_field)
def _crf_mean_field_flops(kern_shape, thresh_shape, bin0_shape,
                          targets_shape, num_iter, kernel_size,
                          out_shape=None, **kwargs) -> int:
    """The stencil's multiply-add per offset, pixel and round, over every
    pixel of every plane (the dense count)."""
    n = 1
    for k in bin0_shape:
        n *= k
    return 2 * kernel_size * kernel_size * n * num_iter


def crf_mean_field(kern: torch.Tensor, thresh: torch.Tensor,
                   bin0: torch.Tensor, targets: torch.Tensor, num_iter: int,
                   kernel_size: int = 3) -> torch.Tensor:
    """The binary mean-field fixed point (no gradient), in bin0's dtype.

    Calls the op ``boxinstseg::crf_mean_field``: the kernel for CUDA
    tensors, in fp32 whatever the inputs' dtype (a bf16 input, as autocast
    leaves it, is cast as the JAX wrapper casts), the plain version for
    CPU tensors. A kernel size other than 3 raises on either."""
    if bin0.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'no CRF fixed point for device {bin0.device}')
    args = [as_fp32(t.detach()).contiguous()
            for t in (kern, thresh, bin0, targets)]
    return crf_mean_field_op(*args, int(num_iter),
                             int(kernel_size)).to(bin0.dtype)
