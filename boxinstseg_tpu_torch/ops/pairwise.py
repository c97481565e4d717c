"""BoxInst pairwise affinity loss: plain PyTorch version and the CUDA
kernel pair (``csrc/pairwise.cu``).

Math (reference condinst_head.py:86-114, 1316-1325): with
p = sigmoid(logit), P(same) = p_i p_j + (1-p_i)(1-p_j); the term is
-log P(same) in log space, over the dilated neighbour offsets of
``neighbor_offsets``, weighted by [colour similarity >= thresh] * box
bitmask * valid, and normalised by max(sum of weights, 1), the sum over
the global batch under a process group (``parallel.dist``). Out-of-image
neighbours see zero log-probs, so their term vanishes.

``boxinst_pairwise_loss`` calls the registered torch ops
``boxinstseg::pairwise_forward`` (K1: the numerator, this process's
denominator and K1's live map) and ``boxinstseg::pairwise_backward`` (K2,
the forward op's gradient), whose implementation the dispatcher picks by
the device of the inputs: the kernels on a CUDA tensor, the plain version
(``pairwise_num_den_plain``, ``pairwise_grad_plain``) on a CPU tensor. Both
have the same analytic backward (the dual of the reference's
pairwise_nlog_backward, pairwise.cu:52-66). The denominator's reduction
over a process group runs in ``boxinst_pairwise_loss``, outside the ops.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ..parallel import dist as pdist
from ._native import as_fp32, check, load_library
from .color import neighbor_offsets, shift2d


# ------------------------------------------------------------ plain version

def _log_probs(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return F.logsigmoid(x), F.logsigmoid(-x)


def _neighbour(xp: torch.Tensor, dy: int, dx: int, r: int, h: int, w: int):
    """xp[..., r+dy : r+dy+h, r+dx : r+dx+w] of a tensor padded by r."""
    return xp[..., r + dy:r + dy + h, r + dx:r + dx + w]


def pairwise_num_den_plain(mask_logits, color_sim, bitmasks, valid,
                           color_thresh=0.3, kernel_size=3, dilation=2):
    """(numerator, denominator) of the weighted pairwise loss.

    mask_logits, bitmasks: (B, K, H, W); color_sim: (B, K^2-1, H, W);
    valid: (B, K) bool."""
    h, w = mask_logits.shape[-2:]
    r = (kernel_size // 2) * dilation
    log_fg, log_bg = _log_probs(mask_logits)
    fg_p = F.pad(log_fg, (r, r, r, r))
    bg_p = F.pad(log_bg, (r, r, r, r))
    base_w = bitmasks * valid.to(mask_logits.dtype)[..., None, None]
    num = mask_logits.new_zeros(())
    den = mask_logits.new_zeros(())
    for k, (dy, dx) in enumerate(neighbor_offsets(kernel_size, dilation)):
        nb_fg = _neighbour(fg_p, dy, dx, r, h, w)
        nb_bg = _neighbour(bg_p, dy, dx, r, h, w)
        log_same = torch.logaddexp(log_fg + nb_fg, log_bg + nb_bg)
        gate = (color_sim[:, k] >= color_thresh).to(mask_logits.dtype)
        w_ = base_w * gate[:, None]
        num = num + torch.sum(-log_same * w_)
        den = den + torch.sum(w_)
    return num, den


def pairwise_grad_plain(mask_logits, color_sim, bitmasks, valid,
                        color_thresh=0.3, kernel_size=3, dilation=2):
    """Unscaled d(num)/d(logits) (the caller multiplies by
    g / max(den, 1)). Per offset o the gradient at p is
    w_o(p) (s(p) - pA_o(p)) + w_o(p-o) (s(p) - pA_o(p-o)) with
    s = sigmoid(x) and pA the normalised same-foreground probability."""
    h, w = mask_logits.shape[-2:]
    r = (kernel_size // 2) * dilation
    log_fg, log_bg = _log_probs(mask_logits)
    s = torch.sigmoid(mask_logits)
    fg_p = F.pad(log_fg, (r, r, r, r))
    bg_p = F.pad(log_bg, (r, r, r, r))
    s_p = F.pad(s, (r, r, r, r))
    base_w = bitmasks * valid.to(mask_logits.dtype)[..., None, None]
    grad = torch.zeros_like(mask_logits)
    for k, (dy, dx) in enumerate(neighbor_offsets(kernel_size, dilation)):
        nb_fg = _neighbour(fg_p, dy, dx, r, h, w)
        nb_bg = _neighbour(bg_p, dy, dx, r, h, w)
        a = log_fg + nb_fg
        m = torch.logaddexp(a, log_bg + nb_bg)
        p_a = torch.exp(a - m)
        gate = (color_sim[:, k] >= color_thresh).to(mask_logits.dtype)
        w_ = base_w * gate[:, None]
        grad = grad + w_ * (s - p_a)                       # p as centre
        nb_s = _neighbour(s_p, dy, dx, r, h, w)
        grad = grad + shift2d(w_ * (nb_s - p_a), -dy, -dx)  # p as neighbour
    return grad


# ----------------------------------------------------- the kernels' tiling

# one tile of output pixels a block: csrc/pairwise.cu's TILE_H x TILE_W
TILE_H, TILE_W = 8, 32


def live_tiles(bitmasks, valid, above, below, side, tile_h=TILE_H,
               tile_w=TILE_W):
    """(B, K, tiles_y, tiles_x) bool: whether a box weight (a non-zero
    bitmask pixel of a valid instance) lies in rows [y0 - above, y0 + tile_h
    + below) and columns [x0 - side, x0 + tile_w + side) of the tile whose
    corner is (y0, x0), clipped to the map. The kernels vote on the same
    windows: K1 on (0, r, r), K2 on (r, r, r) with r = kernel_size // 2 *
    dilation; an instance skips every tile that is not live."""
    b, k, h, w = bitmasks.shape
    ty, tx = -(-h // tile_h), -(-w // tile_w)
    wmap = ((bitmasks != 0) & valid[..., None, None]).float()
    wmap = F.pad(wmap.reshape(b * k, 1, h, w),
                 (side, tx * tile_w - w + side, above,
                  ty * tile_h - h + below))
    pooled = F.max_pool2d(wmap, (tile_h + above + below, tile_w + 2 * side),
                          (tile_h, tile_w))
    return pooled.reshape(b, k, ty, tx) > 0


# ------------------------------------------------------------- CUDA kernels

@functools.lru_cache(maxsize=None)
def _lib():
    """Build (first call) and type the C interface of csrc/pairwise.cu."""
    lib = load_library('pairwise')
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pairwise_forward.argtypes = [p] * 7 + [i] * 7 + [f, i, p]
    lib.pairwise_forward.restype = i
    lib.pairwise_backward.argtypes = [p] * 7 + [i] * 7 + [f, i, p]
    lib.pairwise_backward.restype = i
    lib.pairwise_forward_blocks.argtypes = [i] * 4
    lib.pairwise_forward_blocks.restype = i
    lib.pairwise_live_items.argtypes = [i] * 4
    lib.pairwise_live_items.restype = i
    return lib


def _check_inputs(mask_logits, color_sim, bitmasks, valid, kernel_size,
                  dilation):
    """Raise on what the kernels do not take. The C side refuses a halo
    (kernel_size // 2 * dilation) above 16 with cudaErrorInvalidValue."""
    for name, t in (('mask_logits', mask_logits), ('color_sim', color_sim),
                    ('bitmasks', bitmasks), ('valid', valid)):
        if not t.is_cuda:
            raise ValueError(f'{name} must be a CUDA tensor')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if t.device != mask_logits.device:
            raise ValueError(f'{name} is on {t.device}, logits on '
                             f'{mask_logits.device}')
    _check_layout(mask_logits, color_sim, bitmasks, valid, kernel_size)


def _check_layout(mask_logits, color_sim, bitmasks, valid, kernel_size):
    """The shapes and types the ops take; no device or stride check, so it
    also runs on fake tensors."""
    for name, t in (('mask_logits', mask_logits), ('color_sim', color_sim),
                    ('bitmasks', bitmasks)):
        if t.dtype != torch.float32:
            raise ValueError(f'{name} must be float32, got {t.dtype}')
    if valid.dtype != torch.bool:
        raise ValueError(f'valid must be bool, got {valid.dtype}')
    if mask_logits.dim() != 4:
        raise ValueError(f'mask_logits must be (B, K, H, W), got '
                         f'{tuple(mask_logits.shape)}')
    b, k, h, w = mask_logits.shape
    g = kernel_size * kernel_size - 1
    if kernel_size % 2 != 1 or kernel_size < 3:
        raise ValueError(f'kernel_size must be odd and >= 3: {kernel_size}')
    if tuple(bitmasks.shape) != (b, k, h, w):
        raise ValueError(f'bitmasks {tuple(bitmasks.shape)} != logits '
                         f'{(b, k, h, w)}')
    if tuple(color_sim.shape) != (b, g, h, w):
        raise ValueError(f'color_sim {tuple(color_sim.shape)} != '
                         f'{(b, g, h, w)}')
    if tuple(valid.shape) != (b, k):
        raise ValueError(f'valid {tuple(valid.shape)} != {(b, k)}')
    if b > 65535 or k > 65535:
        raise ValueError(f'B={b} and K={k} must each be <= 65535')


def _launch_args(mask_logits, color_sim, bitmasks, valid, color_thresh,
                 kernel_size, dilation, *out):
    """The C entries' arguments after the output pointers ``out``. vec
    (16-byte loads and stores of rows) needs W % 4 == 0 and aligned
    planes; the outputs the wrappers allocate are aligned."""
    b, k, h, w = mask_logits.shape
    vec = w % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in
                             (bitmasks,) + out)
    return (b, k, h, w, kernel_size * kernel_size - 1, kernel_size // 2,
            dilation, float(color_thresh), int(vec),
            torch.cuda.current_stream(mask_logits.device).cuda_stream)


def pairwise_forward_cuda(mask_logits, color_sim, bitmasks, valid,
                          color_thresh=0.3, kernel_size=3, dilation=2,
                          keep_live=False):
    """K1: (num, den) scalars of the weighted pairwise loss. With
    ``keep_live`` also the live map that ``pairwise_grad_cuda`` takes: one
    byte a (b, k, tile), whether K2 has work there."""
    out, live = _forward_launch(mask_logits, color_sim, bitmasks, valid,
                                color_thresh, kernel_size, dilation,
                                keep_live)
    if keep_live:
        return out[0], out[1], live
    return out[0], out[1]


def _forward_launch(mask_logits, color_sim, bitmasks, valid, color_thresh,
                    kernel_size, dilation, keep_live):
    """K1's launch: ((num, den) as one (2,) tensor, the live map or an
    empty one)."""
    _check_inputs(mask_logits, color_sim, bitmasks, valid, kernel_size,
                  dilation)
    lib = _lib()
    b, k, h, w = mask_logits.shape
    dev = mask_logits.device
    part = torch.empty(2 * lib.pairwise_forward_blocks(b, k, h, w),
                       dtype=torch.float32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    live = torch.empty(lib.pairwise_live_items(b, k, h, w)
                       if keep_live else 0, dtype=torch.uint8, device=dev)
    args = _launch_args(mask_logits, color_sim, bitmasks, valid,
                        color_thresh, kernel_size, dilation)
    with torch.cuda.device(dev):
        err = lib.pairwise_forward(
            mask_logits.data_ptr(), color_sim.data_ptr(),
            bitmasks.data_ptr(), valid.data_ptr(), part.data_ptr(),
            out.data_ptr(), live.data_ptr() if keep_live else None, *args)
    check(err, 'pairwise_forward')
    pairwise_forward_cuda.launches += 1
    return out, live


pairwise_forward_cuda.launches = 0


def pairwise_grad_cuda(mask_logits, color_sim, bitmasks, valid, scale,
                       color_thresh=0.3, kernel_size=3, dilation=2,
                       live=None):
    """K2: d(num)/d(logits) * scale, where ``scale`` is a one-element
    float32 CUDA tensor (read on the device: no host sync). ``live``: the
    map ``pairwise_forward_cuda(..., keep_live=True)`` made of the same
    inputs; without it K2 finds its work in the bitmask itself."""
    _check_inputs(mask_logits, color_sim, bitmasks, valid, kernel_size,
                  dilation)
    if scale.numel() != 1 or scale.dtype != torch.float32 \
            or scale.device != mask_logits.device:
        raise ValueError('scale must be one float32 on the logits device')
    scale = scale.contiguous()
    lib = _lib()
    if live is not None and (
            live.dtype != torch.uint8 or live.device != mask_logits.device
            or not live.is_contiguous() or live.numel() !=
            lib.pairwise_live_items(*mask_logits.shape)):
        raise ValueError('live must be the uint8 map pairwise_forward_cuda '
                         'kept for these inputs')
    grad = torch.empty_like(mask_logits)
    args = _launch_args(mask_logits, color_sim, bitmasks, valid,
                        color_thresh, kernel_size, dilation, grad)
    with torch.cuda.device(mask_logits.device):
        err = lib.pairwise_backward(
            mask_logits.data_ptr(), color_sim.data_ptr(),
            bitmasks.data_ptr(), valid.data_ptr(), scale.data_ptr(),
            grad.data_ptr(), None if live is None else live.data_ptr(),
            *args)
    check(err, 'pairwise_backward')
    pairwise_grad_cuda.launches += 1
    return grad


pairwise_grad_cuda.launches = 0


# --------------------------------------------------- registered torch ops

def live_items(b: int, k: int, h: int, w: int) -> int:
    """Bytes of K1's live map: one a (instance, tile)."""
    return b * k * -(-h // TILE_H) * -(-w // TILE_W)


@torch.library.custom_op('boxinstseg::pairwise_forward', mutates_args=(),
                         device_types='cuda')
def pairwise_forward_op(mask_logits: torch.Tensor, color_sim: torch.Tensor,
                        bitmasks: torch.Tensor, valid: torch.Tensor,
                        color_thresh: float, kernel_size: int, dilation: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as a torch op: (num_den, live). num_den (2,) float32 holds the
    numerator and this process's denominator (the two are one buffer of
    the kernel, and an op's outputs may not share one); live (B*K*tiles,)
    uint8 is K1's live map, which the backward op takes. No collective
    runs here: the caller reduces the denominator."""
    return _forward_launch(mask_logits, color_sim, bitmasks, valid,
                           color_thresh, kernel_size, dilation, True)


@pairwise_forward_op.register_kernel('cpu')
def _pairwise_forward_cpu(mask_logits, color_sim, bitmasks, valid,
                          color_thresh, kernel_size, dilation):
    _check_layout(mask_logits, color_sim, bitmasks, valid, kernel_size)
    num, den = pairwise_num_den_plain(mask_logits, color_sim, bitmasks,
                                      valid, color_thresh, kernel_size,
                                      dilation)
    r = kernel_size // 2 * dilation
    live = live_tiles(bitmasks, valid, 0, r, r).to(torch.uint8).reshape(-1)
    return torch.stack((num, den)), live


@pairwise_forward_op.register_fake
def _pairwise_forward_fake(mask_logits, color_sim, bitmasks, valid,
                           color_thresh, kernel_size, dilation):
    _check_layout(mask_logits, color_sim, bitmasks, valid, kernel_size)
    return (mask_logits.new_empty((2,)),
            mask_logits.new_empty((live_items(*mask_logits.shape),),
                                  dtype=torch.uint8))


@torch.library.custom_op('boxinstseg::pairwise_backward', mutates_args=(),
                         device_types='cuda')
def pairwise_backward_op(mask_logits: torch.Tensor, color_sim: torch.Tensor,
                         bitmasks: torch.Tensor, valid: torch.Tensor,
                         scale: torch.Tensor, live: torch.Tensor,
                         color_thresh: float, kernel_size: int, dilation: int
                         ) -> torch.Tensor:
    """K2 as a torch op: d(num)/d(logits) * scale, ``scale`` a one-element
    float32 tensor (read on the device), ``live`` the forward op's map."""
    return pairwise_grad_cuda(mask_logits, color_sim, bitmasks, valid,
                              scale, color_thresh, kernel_size, dilation,
                              live=live)


@pairwise_backward_op.register_kernel('cpu')
def _pairwise_backward_cpu(mask_logits, color_sim, bitmasks, valid, scale,
                           live, color_thresh, kernel_size, dilation):
    _check_layout(mask_logits, color_sim, bitmasks, valid, kernel_size)
    return pairwise_grad_plain(mask_logits, color_sim, bitmasks, valid,
                               color_thresh, kernel_size, dilation) * scale


@pairwise_backward_op.register_fake
def _pairwise_backward_fake(mask_logits, color_sim, bitmasks, valid, scale,
                            live, color_thresh, kernel_size, dilation):
    _check_layout(mask_logits, color_sim, bitmasks, valid, kernel_size)
    return torch.empty_like(mask_logits)


def _pairwise_setup_context(ctx, inputs, output):
    mask_logits, color_sim, bitmasks, valid, *cfg = inputs
    ctx.save_for_backward(mask_logits, color_sim, bitmasks, valid, output[1])
    ctx.cfg = cfg


def _pairwise_backward_formula(ctx, grad_num_den, grad_live):
    """The logits' gradient: K2 at scale d(loss)/d(num). The denominator
    does not depend on the logits, so its gradient is dropped."""
    mask_logits, color_sim, bitmasks, valid, live = ctx.saved_tensors
    scale = grad_num_den[:1].contiguous()
    return (pairwise_backward_op(mask_logits, color_sim, bitmasks, valid,
                                 scale, live, *ctx.cfg),
            None, None, None, None, None, None)


pairwise_forward_op.register_autograd(
    _pairwise_backward_formula, setup_context=_pairwise_setup_context)

# operations a (pixel, instance), counted from csrc/pairwise.cu (a
# transcendental counts as one): K1 the two log-sigmoids, then per offset a
# pair log-prob, a logaddexp and the weighted sum; K2 adds the pair
# probability and the gradient terms. At the main path's 8 offsets they
# are 90 and 120.
K1_OPS_BASE, K1_OPS_PER_OFFSET = 10, 10
K2_OPS_BASE, K2_OPS_PER_OFFSET = 8, 14


def _pixels_and_offsets(logits_shape, color_sim_shape):
    n = 1
    for k in logits_shape:
        n *= k
    return n, color_sim_shape[1]


@register_flop_formula(torch.ops.boxinstseg.pairwise_forward)
def _pairwise_forward_flops(logits_shape, color_sim_shape, bitmasks_shape,
                            valid_shape, *args, out_shape=None,
                            **kwargs) -> int:
    """The dense count over every (pixel, instance); the kernel skips the
    tiles without a box weight near them, so it does at most this."""
    n, g = _pixels_and_offsets(logits_shape, color_sim_shape)
    return n * (K1_OPS_BASE + K1_OPS_PER_OFFSET * g)


@register_flop_formula(torch.ops.boxinstseg.pairwise_backward)
def _pairwise_backward_flops(logits_shape, color_sim_shape, bitmasks_shape,
                             valid_shape, *args, out_shape=None,
                             **kwargs) -> int:
    """The dense count, as the forward's."""
    n, g = _pixels_and_offsets(logits_shape, color_sim_shape)
    return n * (K2_OPS_BASE + K2_OPS_PER_OFFSET * g)


def boxinst_pairwise_loss(mask_logits: torch.Tensor,
                          color_sim: torch.Tensor,
                          bitmasks: torch.Tensor,
                          valid: torch.Tensor,
                          color_thresh: float = 0.3,
                          kernel_size: int = 3,
                          dilation: int = 2) -> torch.Tensor:
    """BoxInst pairwise loss over sampled instances.

    Args:
      mask_logits: (B, K, H, W) sampled-instance mask logits.
      color_sim: (B, K^2-1, H, W) per-image colour similarity.
      bitmasks: (B, K, H, W) GT box bitmasks of the sampled instances.
      valid: (B, K) bool sample validity.

    Calls the op ``boxinstseg::pairwise_forward``: the kernels for CUDA
    tensors (which raise on what they do not take), the plain version for
    CPU tensors. The kernels take fp32 (as the JAX wrapper casts): bf16 or
    fp16 inputs, as autocast leaves them, run in fp32, and the loss and
    the logits' gradient come back in the logits' dtype. The denominator
    is reduced over the process group here (``parallel.dist``), outside
    the op."""
    if mask_logits.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'no pairwise loss for device {mask_logits.device}')
    dtype = mask_logits.dtype
    mask_logits, color_sim, bitmasks = (
        as_fp32(t).contiguous() for t in (mask_logits, color_sim, bitmasks))
    num_den, _ = pairwise_forward_op(mask_logits, color_sim, bitmasks,
                                     valid.contiguous(), float(color_thresh),
                                     int(kernel_size), int(dilation))
    den = pdist.reduce_mean_denominator(num_den[1].detach(), 1.0)
    return (num_den[0] / den).to(dtype)
