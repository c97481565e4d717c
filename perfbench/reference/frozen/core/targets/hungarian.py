"""Hungarian matching for mask transformers, counterpart of
``boxinstseg_tpu/core/targets/hungarian.py`` (reference:
MaskHungarianAssigner, mask_hungarian_assigner.py:113-123, with
ClassificationCost + BoxMatchingCost, match_cost.py:365-425).

The costs and the assignment are computed on the device: every problem of
a step goes through one ``ops.lsa.solve_lsa`` call (the CUDA kernel on the
card), the JAX package's exact Jonker-Volgenant solver step for step, so
that tied costs resolve as they do there; the host never waits.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...ops.lsa import solve_lsa


def classification_cost(cls_scores: torch.Tensor, gt_labels: torch.Tensor
                        ) -> torch.Tensor:
    """-softmax probability of the GT class. cls_scores (B, Q, C+1);
    gt_labels (B, G). Returns (B, Q, G)."""
    probs = torch.softmax(cls_scores, dim=-1)
    b, q, _ = probs.shape
    idx = gt_labels.long()[:, None, :].expand(b, q, gt_labels.shape[1])
    return -torch.gather(probs, 2, idx)


def box_matching_cost(mask_preds: torch.Tensor, gt_box_masks: torch.Tensor,
                      eps: float = 1.0) -> torch.Tensor:
    """x- and y-projected 1-D dice cost (reference BoxMatchingCost with
    pred_act=True). mask_preds (B, Q, H, W) logits; gt_box_masks
    (B, G, H, W). Returns (B, Q, G)."""
    p = torch.sigmoid(mask_preds)
    t = gt_box_masks.to(p.dtype)

    def proj_dice(pp, tt):                      # (B, Q, L), (B, G, L)
        num = 2 * torch.einsum('bql,bgl->bqg', pp, tt)
        den = (pp ** 2).sum(-1)[:, :, None] + (tt ** 2).sum(-1)[:, None, :]
        return 1.0 - (num + eps) / (den + eps)

    return (proj_dice(p.amax(dim=2), t.amax(dim=2))
            + proj_dice(p.amax(dim=3), t.amax(dim=3)))


def hungarian_match(cost: torch.Tensor, gt_valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cost (B, Q, G), any values in the padded columns; gt_valid (B, G).
    Returns (assigned query (B, G) int64, zero in the padded slots,
    gt_valid).

    As the JAX function: the GTs (rows) are sorted valid-first, stably,
    the padded rows zeroed, and only the live count is augmented; the
    padded slots take no part."""
    b, q, g = cost.shape
    assert g <= q, (g, q)
    valid = gt_valid.bool()
    order = torch.sort((~valid).to(torch.uint8), dim=1,
                       stable=True).indices                    # (B, G)
    valid_sorted = torch.gather(valid, 1, order)
    cost_t = torch.gather(cost.detach().transpose(1, 2), 1,
                          order[:, :, None].expand(b, g, q))
    cost_t = torch.where(valid_sorted[:, :, None], cost_t,
                         torch.zeros((), dtype=cost_t.dtype,
                                     device=cost_t.device))
    n_valid = valid.sum(dim=1).to(torch.int32)
    assigned_sorted = solve_lsa(cost_t, n_valid)                 # (B, G)
    inv = torch.argsort(order, dim=1)
    assigned = torch.gather(assigned_sorted, 1, inv)
    return torch.where(valid, assigned, torch.zeros_like(assigned)), \
        gt_valid
