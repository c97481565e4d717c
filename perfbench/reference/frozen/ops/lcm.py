"""Frozen copy: the plain version alone, which the public entry at the
end of this file calls. Local Consistency Module refinement: plain PyTorch versions and the CUDA
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

from typing import Sequence, Tuple

import torch


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


def lcm_refine(aff, phi, offsets, num_iter):
    """``num_iter`` LCM rounds of phi (B, C, H, W) with affinities aff
    (B, K, H, W), the plain rounds differentiated by autograd in phi (aff
    is detached)."""
    offsets = tuple((int(dy), int(dx)) for dy, dx in offsets)
    return lcm_forward_plain(aff.detach().float(), phi.float(), offsets,
                             int(num_iter)).to(phi.dtype)
