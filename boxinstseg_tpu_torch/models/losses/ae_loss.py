"""Associative Embedding (CornerNet) pull / push loss, counterpart of
``boxinstseg_tpu/models/losses/ae_loss.py`` (reference:
mmdet/models/losses/ae_loss.py — ae_loss_per_image :11-73,
AssociativeEmbeddingLoss :76-105).

As in the JAX package, the matched corners are a padded (K, 2, 2) integer
tensor with a (K,) validity mask and the embeddings are NHWC; the batch is
a loop over images.
"""
from __future__ import annotations

import torch

from ...registry import LOSSES


def ae_loss_per_image(tl_preds: torch.Tensor, br_preds: torch.Tensor,
                      match: torch.Tensor, match_valid: torch.Tensor):
    """One image's pull and push losses. tl_preds / br_preds (H, W, C);
    match (K, 2, 2) [[tl_y, tl_x], [br_y, br_x]] an object; match_valid
    (K,)."""
    k = match.shape[0]
    c = tl_preds.shape[-1]
    match = match.long()
    # every embedding channel is an "object" of its own (`view(-1, 1)` +
    # `cat`, ae_loss.py:40-50): N = objects x C
    tl_e = tl_preds[match[:, 0, 0], match[:, 0, 1]].reshape(-1)
    br_e = br_preds[match[:, 1, 0], match[:, 1, 1]].reshape(-1)
    valid = match_valid.repeat_interleave(c).to(tl_preds.dtype)
    n = valid.sum()
    me = (tl_e + br_e) / 2.0
    pull = (tl_e - me) ** 2 + (br_e - me) ** 2
    zero = torch.zeros((), dtype=tl_preds.dtype, device=tl_preds.device)
    pull_loss = torch.where(n > 0, (pull * valid).sum() / n.clamp(min=1.0),
                            zero)
    # push: margin - |me_i - me_j| over every pair, without the diagonal
    # and the invalid pairs (conf_mat, ae_loss.py:62-69)
    conf = 1.0 - torch.abs(me[:, None] - me[None, :])
    pair_w = valid[:, None] * valid[None, :] * \
        (1.0 - torch.eye(k * c, dtype=tl_preds.dtype,
                         device=tl_preds.device))
    push = torch.relu(conf) * pair_w
    push_loss = torch.where(
        n > 1, push.sum() / (n * (n - 1.0)).clamp(min=1.0), zero)
    return pull_loss, push_loss


@LOSSES.register_module()
class AssociativeEmbeddingLoss:
    """The AE loss of a batch: (pull, push) summed over the images, as the
    reference's forward (ae_loss.py:96-105)."""

    def __init__(self, pull_weight: float = 0.25,
                 push_weight: float = 0.25):
        self.pull_weight = pull_weight
        self.push_weight = push_weight

    def __call__(self, pred, target, match, match_valid):
        pulls, pushes = zip(*[ae_loss_per_image(*args) for args in zip(
            pred, target, match, match_valid)])
        return self.pull_weight * torch.stack(pulls).sum(), \
            self.push_weight * torch.stack(pushes).sum()
