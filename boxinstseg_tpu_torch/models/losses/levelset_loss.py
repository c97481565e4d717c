"""Chan-Vese level-set losses and the Local Consistency Module,
counterpart of ``boxinstseg_tpu/models/losses/levelset_loss.py``
(reference: mmdet/models/losses/levelset_loss.py).

- ``region_levelset``: two-region Chan-Vese energy whose interior and
  exterior means are soft averages weighted by phi and 1 - phi;
- ``region_levelset_shared``: the same energy against a target shared by
  all instances of an image, from four inner products;
- ``length_regularization``: total-variation curve length;
- ``LevelsetLoss``: ``region_levelset`` per pixel of the box, weighted,
  registered so that a config's ``loss_levelset`` builds by name;
- ``LocalConsistencyModule``: affinity-propagated refinement of phi over
  dilated 3x3 neighbourhoods, run by ``ops.lcm.lcm_refine`` (the CUDA
  kernels on the card).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ...ops.color import neighbor_offsets
from ...ops.lcm import lcm_refine, replicate_shift
from ...registry import LOSSES


def region_levelset(mask_score: torch.Tensor, lst_target: torch.Tensor
                    ) -> torch.Tensor:
    """mask_score (N, 2, H, W): phi and 1 - phi; lst_target (N, C, H, W).
    Returns the (N,) energy averaged over the target channels."""
    fg = mask_score[:, 0:1]
    bg = mask_score[:, 1:2]
    fg_sum = torch.clamp(fg.sum(dim=(2, 3)), min=1e-5)
    bg_sum = torch.clamp(bg.sum(dim=(2, 3)), min=1e-5)
    interior = (fg * lst_target).sum(dim=(2, 3)) / fg_sum    # (N, C)
    exterior = (bg * lst_target).sum(dim=(2, 3)) / bg_sum
    in_term = (lst_target - interior[..., None, None]) ** 2
    ex_term = (lst_target - exterior[..., None, None]) ** 2
    energy = in_term * fg + ex_term * bg
    return energy.sum(dim=(1, 2, 3)) / lst_target.shape[1]


def region_levelset_shared(fg: torch.Tensor, box: torch.Tensor,
                           img: torch.Tensor) -> torch.Tensor:
    """``region_levelset(stack([s, 1-s]) * box, img[:, None] * box)`` without
    the (B, K, C, H, W) product: with F = s * box and G = box - F,
    E_c = <I_c^2, F> - interior_c^2 <F> + <I_c^2, G> - exterior_c^2 <G>.

    fg, box (B, K, H, W); img (B, C, H, W). Returns (B, K)."""
    f = fg * box
    fs = torch.clamp(f.sum(dim=(2, 3)), min=1e-5)
    bs = box.sum(dim=(2, 3))
    gs = torch.clamp(bs - f.sum(dim=(2, 3)), min=1e-5)
    img2 = img * img
    a = torch.einsum('bchw,bkhw->bkc', img, f)
    a2 = torch.einsum('bchw,bkhw->bkc', img2, f)
    ib = torch.einsum('bchw,bkhw->bkc', img, box)
    ib2 = torch.einsum('bchw,bkhw->bkc', img2, box)
    interior = a / fs[..., None]
    exterior = (ib - a) / gs[..., None]
    energy = (a2 - interior ** 2 * fs[..., None]
              + (ib2 - a2) - exterior ** 2 * gs[..., None])
    return energy.sum(-1) / img.shape[1]


def length_regularization(mask_score: torch.Tensor) -> torch.Tensor:
    """Curve length of phi from absolute forward differences:
    (N, C, H, W) -> (N,)."""
    gh = (mask_score[:, :, 1:, :] - mask_score[:, :, :-1, :]).abs()
    gw = (mask_score[:, :, :, 1:] - mask_score[:, :, :, :-1]).abs()
    return gh.sum(dim=(1, 2, 3)) + gw.sum(dim=(1, 2, 3))


@LOSSES.register_module()
class LevelsetLoss:
    def __init__(self, loss_weight: float = 1.0):
        self.loss_weight = loss_weight

    def __call__(self, mask_logits, targets, pixel_num):
        return self.loss_weight * region_levelset(
            mask_logits, targets) / pixel_num


class LocalConsistencyModule:
    """Affinity-propagated phi refinement (reference levelset_loss.py:
    76-127): the affinity between a pixel and its 8 dilated neighbours is a
    softmax over the neighbours of minus the squared, std-normalised image
    difference; phi is replaced ``num_iter`` times by the affinity-weighted
    sum of its neighbours. The refinement is linear in phi; its backward
    is the adjoint operator (``ops.lcm``)."""

    def __init__(self, dilations: Sequence[int] = (2,), num_iter: int = 10,
                 alpha: float = 0.3):
        self.dilations = list(dilations)
        self.num_iter = num_iter
        self.alpha = alpha

    def offsets(self):
        return [(dy, dx) for d in self.dilations
                for dy, dx in neighbor_offsets(3, d)]

    def affinity(self, imgs: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) images -> (N, K, H, W) affinities (softmax over K).
        The std over the K neighbours is the unbiased one (ddof=1)."""
        nb = torch.stack([replicate_shift(imgs, dy, dx)
                          for dy, dx in self.offsets()], dim=2)
        diff = (nb - imgs[:, :, None]).abs()
        std = torch.std(nb, dim=2, keepdim=True)
        aff = -((diff / (std + 1e-8) / self.alpha) ** 2)
        return torch.softmax(aff.mean(dim=1), dim=1)

    def __call__(self, imgs: torch.Tensor, pred_phis: torch.Tensor
                 ) -> torch.Tensor:
        with torch.no_grad():
            aff = self.affinity(imgs)
        return lcm_refine(aff, pred_phis, self.offsets(), self.num_iter)
