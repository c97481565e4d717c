"""Swin window attention: plain PyTorch versions and the CUDA kernel pair
(``csrc/swin_attention.cu``).

Counterpart of ``window_attention`` in
``boxinstseg_tpu/ops/swin_attention.py`` (forward ``_flash_fwd``, backward
``_flash_bwd``), in its layout:

- q, k, v (BW, N, C) with C = H * D; head h is columns [h*D, (h+1)*D);
- bias_hnn (H, N, N) fp32, the relative-position bias;
- regions (nW, 1, N) int32, the shift-partition ids of ``shift_regions``;
  window bw uses region row ``bw % nW`` (windows are image-major);
- per window and head, ``softmax(q k^T * scale + bias[h] + mask) v`` with
  ``mask = -100`` where ``region[i] != region[j]`` (not -inf, as in mmdet);
  padded tokens take part like any other.

The backward gives dq, dk, dv and dbias summed over the BW windows;
regions get no gradient.

``window_attention_qkv`` takes the fused (BW, N, 3C) output of the qkv
Linear, which is what the backbone passes: the kernels read q, k and v as
its column slices (no copies) and the backward writes one (BW, N, 3C)
gradient. It calls the registered torch op ``boxinstseg::window_attention``
(``torch.library.custom_op``), whose implementation the dispatcher picks by
the device of the inputs: K5 on a CUDA tensor, ``window_attention_plain``
on a CPU tensor. Its gradient is the op
``boxinstseg::window_attention_backward`` (K6; on the CPU
``window_attention_backward_plain``). A fake implementation gives each
op's output shapes from its inputs' shapes, so that ``torch.export`` and
``FlopCounterMode`` trace through it; the flop formulas count 4 N^2 C a
window forward and 8 N^2 C backward, as torch counts attention.
"""
from __future__ import annotations

import ctypes
import functools

from typing import Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from ._native import as_fp32, check, load_library

NEG = -100.0                 # the additive constant of the shift mask
MAX_N, MAX_D = 256, 128      # the kernels' limits (csrc/swin_attention.cu)
SMEM_LIMIT = 232448          # dynamic shared memory a block may use (H100)
SM_SMEM = 233472             # shared memory of one SM (H100)
KEY_TILES = (2, 4, 8, 18, 32)    # the kernels' template sizes, 8 keys a tile


@functools.lru_cache(maxsize=None)
def shift_regions(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(nW, 1, N) int32 region ids of the cyclically shifted 9-region
    partition, window-partitioned exactly like the tokens. shift == 0
    gives all-zero rows (no mask)."""
    img = np.zeros((hp, wp), np.int32)
    if shift > 0:
        cnt = 0
        for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            for wsl in (slice(0, -ws), slice(-ws, -shift),
                        slice(-shift, None)):
                img[hs, wsl] = cnt
                cnt += 1
    r = img.reshape(hp // ws, ws, wp // ws, ws)
    return r.transpose(0, 2, 1, 3).reshape(-1, 1, ws * ws)


# ------------------------------------------------------------ plain version

def _heads(x, h):
    bw, n, c = x.shape
    return x.reshape(bw, n, h, c // h).transpose(1, 2)      # (BW, H, N, D)


def _merge_heads(x):
    bw, h, n, d = x.shape
    return x.transpose(1, 2).reshape(bw, n, h * d)


def _probs(q, k, bias_hnn, regions, scale):
    """(BW, H, N, N) softmax of the masked, biased logits."""
    h = bias_hnn.shape[0]
    bw = q.shape[0]
    r = regions[:, 0]                                        # (nW, N)
    mask = torch.where(r[:, :, None] != r[:, None, :], NEG, 0.0).to(q.dtype)
    mask = mask[torch.arange(bw, device=q.device) % r.shape[0]]
    logits = torch.matmul(_heads(q, h), _heads(k, h).transpose(-1, -2)) \
        * scale + bias_hnn[None] + mask[:, None]
    return torch.softmax(logits, dim=-1)


def window_attention_plain(q, k, v, bias_hnn, regions, scale):
    """(BW, N, C) = softmax(q k^T * scale + bias[h] + mask) v per head."""
    p = _probs(q, k, bias_hnn, regions, scale)
    return _merge_heads(torch.matmul(p, _heads(v, bias_hnn.shape[0])))


def window_attention_backward_plain(q, k, v, bias_hnn, regions, scale, g):
    """(dq, dk, dv, dbias) of ``window_attention_plain``; dbias sums over
    the windows."""
    h = bias_hnn.shape[0]
    p = _probs(q, k, bias_hnn, regions, scale)
    gh = _heads(g, h)
    dv = torch.matmul(p.transpose(-1, -2), gh)
    dp = torch.matmul(gh, _heads(v, h).transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, _heads(k, h)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q, h)) * scale
    return (_merge_heads(dq), _merge_heads(dk), _merge_heads(dv),
            ds.sum(0))


def _split(qkv):
    c = qkv.shape[-1] // 3
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]


# ------------------------------------------------------------- CUDA kernels

@functools.lru_cache(maxsize=None)
def _lib():
    """Build (first call) and type the C interface of
    csrc/swin_attention.cu."""
    lib = load_library('swin_attention')
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.swin_attention_forward.argtypes = ([p] * 3 + [i] + [p] * 3 + [i] * 5
                                           + [f] + [i] * 2 + [p])
    lib.swin_attention_forward.restype = i
    lib.swin_attention_backward.argtypes = ([p] * 3 + [i] + [p] * 6
                                            + [i] * 5 + [f] + [i] * 2 + [p])
    lib.swin_attention_backward.restype = i
    return lib


def key_tiles(n: int) -> int:
    """Tiles of 8 keys a warp's strip holds: the kernels' template size."""
    return next(kt for kt in KEY_TILES if 8 * kt >= n)


def plan_bytes(n: int, d: int, backward: bool, bias_smem: bool) -> int:
    """Dynamic shared memory of the kernels (``plan_floats`` in the
    source): the head's bias (NR x (NR + 8)) if it is kept there, for the
    backward the dbias accumulator of that size and three row statistics,
    and the q, k, v (and g) tiles (NR x (D32 + 4)) and a region row, NR = 8
    * key_tiles(n) rows, D32 = d rounded up to 32."""
    nr = 8 * key_tiles(n)
    bias = nr * (nr + 8)
    tiles = (4 if backward else 3) * nr * (-(-d // 32) * 32 + 4) + nr
    return 4 * ((bias if bias_smem else 0)
                + (bias + 3 * nr if backward else 0) + tiles)


def smem_plan(n: int, d: int, backward: bool):
    """(bias_smem, bytes): the bias in shared memory when it fits a block
    (it saves the L2 reads of every window), else read from L2; None when
    neither fits."""
    for bias_smem in (True, False):
        need = plan_bytes(n, d, backward, bias_smem)
        if need <= SMEM_LIMIT:
            return bias_smem, need
    return None


@functools.lru_cache(maxsize=None)
def window_groups(bw: int, h: int, smem: int, threads: int,
                  sms: int) -> int:
    """Window groups G: G * H persistent blocks, each walking at most
    ceil(BW / G) windows. Picks the G with the least time in windows: the
    waves of blocks (beyond those resident at once, by shared memory and
    threads) times each block's windows plus one for its set-up (zeroing
    shared memory, the bias, the first copies); among equals the smallest
    G (fewest dbias partials)."""
    per_sm = max(1, min(SM_SMEM // (smem + 1024), 2048 // threads, 32))
    resident = sms * per_sm
    return min(range(1, bw + 1),
               key=lambda g: (-(-h * g // resident) * (-(-bw // g) + 1), g))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_layout(q, k, v, bias_hnn, regions, g=None):
    """Devices, types, shapes and strides of the op's inputs; returns (BW,
    N, H, D, nW, ld). Reads no value, so it also runs on fake tensors."""
    named = [('q', q), ('k', k), ('v', v), ('bias_hnn', bias_hnn),
             ('regions', regions)] + ([('g', g)] if g is not None else [])
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f'{name} is on {t.device}, q on {q.device}')
        want = torch.int32 if name == 'regions' else torch.float32
        if t.dtype != want:
            raise ValueError(f'{name} must be {want}, got {t.dtype}')
    if q.dim() != 3:
        raise ValueError(f'q must be (BW, N, C), got {tuple(q.shape)}')
    bw, n, c = q.shape
    ld = q.stride(1)
    for name, t in (('q', q), ('k', k), ('v', v)):
        if tuple(t.shape) != (bw, n, c):
            raise ValueError(f'{name} {tuple(t.shape)} != {(bw, n, c)}')
        if t.stride(2) != 1 or t.stride(1) != ld or t.stride(0) != n * ld:
            raise ValueError(f'{name} must have unit column stride and the '
                             f'row stride of q ({ld}); strides '
                             f'{t.stride()}')
    if bias_hnn.dim() != 3 or bias_hnn.shape[1:] != (n, n) \
            or not bias_hnn.is_contiguous():
        raise ValueError(f'bias_hnn must be contiguous (H, {n}, {n}), got '
                         f'{tuple(bias_hnn.shape)}')
    h = bias_hnn.shape[0]
    if c % h:
        raise ValueError(f'{c} channels do not split into {h} heads')
    d = c // h
    if regions.dim() != 3 or regions.shape[1:] != (1, n) \
            or not regions.is_contiguous():
        raise ValueError(f'regions must be contiguous (nW, 1, {n}), got '
                         f'{tuple(regions.shape)}')
    nw = regions.shape[0]
    if bw % nw:
        raise ValueError(f'{bw} windows are not whole images of {nw}')
    if g is not None and (tuple(g.shape) != (bw, n, c)
                          or not g.is_contiguous()):
        raise ValueError(f'g must be contiguous {(bw, n, c)}')
    return bw, n, h, d, nw, ld


def _check_inputs(q, k, v, bias_hnn, regions, g=None):
    """What the kernels take: ``_check_layout``, CUDA tensors and the
    kernels' limits; returns (BW, N, H, D, nW, ld, (bias_smem,
    shared-memory bytes))."""
    for t in (q, k, v, bias_hnn, regions) + ((g,) if g is not None else ()):
        if not t.is_cuda:
            raise ValueError('the window attention kernels take CUDA '
                             'tensors')
    bw, n, h, d, nw, ld = _check_layout(q, k, v, bias_hnn, regions, g)
    c = h * d
    if n > MAX_N or d > MAX_D:
        raise ValueError(f'N {n} / head dim {d} exceed the kernels\' '
                         f'{MAX_N} / {MAX_D}')
    plan = smem_plan(n, d, g is not None)
    if plan is None:
        need = plan_bytes(n, d, g is not None, False)
        raise ValueError(f'N {n}, head dim {d} need {need} bytes of shared '
                         f'memory, more than a block has ({SMEM_LIMIT})')
    if bw * n * ld >= 2 ** 31 or bw * n * 3 * c >= 2 ** 31:
        raise ValueError('the window attention kernels index rows with '
                         '32-bit counts')
    return bw, n, h, d, nw, ld, plan


def _groups(q, bw, n, h, plan):
    return window_groups(bw, h, plan[1], -(-n // 16) * 32,
                         _sm_count(q.device.index))


def window_attention_forward_cuda(q, k, v, bias_hnn, regions, scale):
    """K5 forward kernel: (BW, N, C)."""
    bw, n, h, d, nw, ld, plan = _check_inputs(q, k, v, bias_hnn, regions)
    lib = _lib()
    groups = _groups(q, bw, n, h, plan)
    out = torch.empty((bw, n, h * d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.swin_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ld,
            bias_hnn.data_ptr(), regions.data_ptr(), out.data_ptr(), bw, n,
            h, d, nw, float(scale), groups, int(plan[0]), stream)
    check(err, 'swin_attention_forward')
    window_attention_forward_cuda.launches += 1
    return out


window_attention_forward_cuda.launches = 0


def window_attention_backward_cuda(q, k, v, bias_hnn, regions, scale, g):
    """K6 backward kernel: (dqkv (BW, N, 3C) = dq | dk | dv, dbias (H, N,
    N) summed over the windows)."""
    bw, n, h, d, nw, ld, plan = _check_inputs(q, k, v, bias_hnn, regions, g)
    lib = _lib()
    groups = _groups(q, bw, n, h, plan)
    dqkv = torch.empty((bw, n, 3 * h * d), dtype=torch.float32,
                       device=q.device)
    partial = torch.empty((groups, h, n, n), dtype=torch.float32,
                          device=q.device)
    dbias = torch.empty((h, n, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.swin_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ld,
            bias_hnn.data_ptr(), regions.data_ptr(), g.data_ptr(),
            dqkv.data_ptr(), partial.data_ptr(), dbias.data_ptr(), bw, n, h,
            d, nw, float(scale), groups, int(plan[0]), stream)
    check(err, 'swin_attention_backward')
    window_attention_backward_cuda.launches += 1
    return dqkv, dbias


window_attention_backward_cuda.launches = 0


# --------------------------------------------------- registered torch ops

@torch.library.custom_op('boxinstseg::window_attention', mutates_args=(),
                         device_types='cuda')
def window_attention_op(qkv: torch.Tensor, bias_hnn: torch.Tensor,
                        regions: torch.Tensor, scale: float) -> torch.Tensor:
    """Window attention of the fused qkv (BW, N, 3C) as a torch op: K5 on
    the card."""
    return window_attention_forward_cuda(*_split(qkv), bias_hnn, regions,
                                         scale)


@window_attention_op.register_kernel('cpu')
def _window_attention_cpu(qkv, bias_hnn, regions, scale):
    _check_layout(*_split(qkv), bias_hnn, regions)
    return window_attention_plain(*_split(qkv), bias_hnn, regions, scale)


@window_attention_op.register_fake
def _window_attention_fake(qkv, bias_hnn, regions, scale):
    bw, n, h, d, _, _ = _check_layout(*_split(qkv), bias_hnn, regions)
    return qkv.new_empty((bw, n, h * d))


@torch.library.custom_op('boxinstseg::window_attention_backward',
                         mutates_args=(), device_types='cuda')
def window_attention_backward_op(qkv: torch.Tensor, bias_hnn: torch.Tensor,
                                 regions: torch.Tensor, scale: float,
                                 grad: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Its backward as a torch op: (dqkv (BW, N, 3C), dbias (H, N, N)), K6
    on the card."""
    return window_attention_backward_cuda(*_split(qkv), bias_hnn, regions,
                                          scale, grad)


@window_attention_backward_op.register_kernel('cpu')
def _window_attention_backward_cpu(qkv, bias_hnn, regions, scale, grad):
    _check_layout(*_split(qkv), bias_hnn, regions, grad)
    dq, dk, dv, dbias = window_attention_backward_plain(
        *_split(qkv), bias_hnn, regions, scale, grad)
    return torch.cat((dq, dk, dv), -1), dbias


@window_attention_backward_op.register_fake
def _window_attention_backward_fake(qkv, bias_hnn, regions, scale, grad):
    _check_layout(*_split(qkv), bias_hnn, regions, grad)
    return torch.empty_like(qkv), torch.empty_like(bias_hnn)


def _setup_context(ctx, inputs, output):
    qkv, bias_hnn, regions, scale = inputs
    ctx.save_for_backward(qkv, bias_hnn, regions)
    ctx.scale = scale


def _backward_formula(ctx, grad):
    qkv, bias_hnn, regions = ctx.saved_tensors
    dqkv, dbias = window_attention_backward_op(qkv, bias_hnn, regions,
                                               ctx.scale, grad.contiguous())
    return dqkv, dbias, None, None


window_attention_op.register_autograd(_backward_formula,
                                      setup_context=_setup_context)


@register_flop_formula(torch.ops.boxinstseg.window_attention)
def _window_attention_flops(qkv_shape, bias_shape, regions_shape, scale,
                            out_shape=None, **kwargs) -> int:
    """q k^T and p v: two products of N x N x D a window and head."""
    bw, n, c3 = qkv_shape
    return 4 * bw * n * n * (c3 // 3)


@register_flop_formula(torch.ops.boxinstseg.window_attention_backward)
def _window_attention_backward_flops(qkv_shape, bias_shape, regions_shape,
                                     scale, grad_shape, out_shape=None,
                                     **kwargs) -> int:
    """dv, dp, dq and dk: four products, as torch counts SDPA's backward."""
    bw, n, c3 = qkv_shape
    return 8 * bw * n * n * (c3 // 3)


def window_attention_qkv(qkv: torch.Tensor, bias_hnn: torch.Tensor,
                         regions: torch.Tensor, scale: float) -> torch.Tensor:
    """Window attention of the fused qkv output (BW, N, 3C) -> (BW, N, C).

    Calls the op ``boxinstseg::window_attention``: K5 / K6 for CUDA tensors
    (which raise on what they do not take), the plain versions for CPU
    tensors. The kernels take fp32: a bf16 or fp16 qkv or bias, as autocast
    leaves them, runs in fp32; the output and dqkv come back in qkv's dtype
    (as the JAX wrapper returns q's), dbias in the bias's."""
    if qkv.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'no window attention for device {qkv.device}')
    dtype = qkv.dtype
    return window_attention_op(
        as_fp32(qkv).contiguous(), as_fp32(bias_hnn).contiguous(),
        regions.contiguous(), float(scale)).to(dtype)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias_hnn: torch.Tensor, regions: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """The JAX package's signature: q, k, v (BW, N, C) head-concat; bias_hnn
    (H, N, N) fp32; regions (nW, 1, N) int32. Returns (BW, N, C).

    Concatenates q, k and v into the fused layout of
    ``window_attention_qkv``, which the backbone calls directly."""
    return window_attention_qkv(torch.cat((q, k, v), -1), bias_hnn, regions,
                                scale)
