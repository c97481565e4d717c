"""Frozen copy: the plain version alone, which the public entry at the
end of this file calls. BoxInst pairwise affinity loss: plain PyTorch version and the CUDA
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

from typing import Tuple

import torch
import torch.nn.functional as F

from ..parallel import dist as pdist
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


# ------------------------------------------- the loss, autograd of the plain

def boxinst_pairwise_loss(mask_logits, color_sim, bitmasks, valid,
                          color_thresh=0.3, kernel_size=3, dilation=2):
    """BoxInst pairwise loss over sampled instances: the plain numerator
    and denominator, differentiated by autograd; the denominator reduced
    over the process group."""
    num, den = pairwise_num_den_plain(mask_logits.float(), color_sim.float(),
                                      bitmasks.float(), valid, color_thresh,
                                      kernel_size, dilation)
    den = pdist.reduce_mean_denominator(den.detach(), 1.0)
    return (num / den).to(mask_logits.dtype)
