"""Hungarian matching for mask transformers, counterpart of
``boxinstseg_tpu/core/targets/hungarian.py`` (reference:
MaskHungarianAssigner, mask_hungarian_assigner.py:113-123, with
ClassificationCost + BoxMatchingCost, match_cost.py:365-425).

The costs are computed on the device; the assignment is solved on the host
with ``scipy.optimize.linear_sum_assignment``, all problems of a step after
one device-to-host copy. The JAX package solves on the device with an exact
Jonker-Volgenant solver; for a cost matrix with a unique optimum both give
the same assignment.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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

    Each problem assigns its valid GTs (rows, in slot order) to distinct
    queries at the least total cost; the padded slots take no part, as
    in the JAX package, where they only soak up leftover queries."""
    b, q, g = cost.shape
    assert g <= q, (g, q)
    from scipy.optimize import linear_sum_assignment
    cost_np = cost.detach().float().cpu().numpy()
    valid_np = gt_valid.detach().cpu().numpy().astype(bool)
    assigned = np.zeros((b, g), np.int64)
    for i in range(b):
        rows = np.nonzero(valid_np[i])[0]
        if len(rows):
            r, cols = linear_sum_assignment(cost_np[i][:, rows].T)
            assigned[i, rows[r]] = cols
    return torch.from_numpy(assigned).to(cost.device), gt_valid
