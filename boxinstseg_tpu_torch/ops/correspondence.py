"""DiscoBox cross-image semantic correspondence, counterpart of
``boxinstseg_tpu/ops/correspondence.py`` (reference: SemanticCorrSolver and
ObjectQueues, discobox_head.py:93-411).

- The per-class object bank is a ring buffer of device tensors. Unlike the
  JAX package's functional buffer, ``bank_append`` writes into it in place:
  the feature buffer is 401 MB at COCO's 80 classes x 100 objects.
- Retrieval (fg/bg mask IoU, appearance similarity, aspect ratio) keeps the
  first ``max_retrieval`` matches in index order.
- Regularised Hough matching: cosine similarity, a distance-kernel mask, a
  fixed number of diagonal message-passing rounds.
- InfoNCE between softmax(Cu) and the argmax of T.
- Entropic Sinkhorn is kept for completeness; the training path does not
  call it, as the reference's solve() does not.

Cell features are channel-last, (..., fh, fw, D) and (B, N, C), the JAX
package's layout.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .upsample import resize_bilinear_antialias


def relu_l2_norm(feat: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """relu, then L2 normalisation over ``dim`` (reference
    relu_and_l2_norm_feat, discobox_head.py:16-20)."""
    feat = F.relu(feat)
    norm = torch.sqrt((feat ** 2).sum(dim=dim, keepdim=True) + 1e-6)
    return feat / (norm + 1e-6)


def sinkhorn(mu: torch.Tensor, nu: torch.Tensor, cost: torch.Tensor,
             reg: float, num_iters: int = 100) -> torch.Tensor:
    """Entropic OT (reference perform_sinkhorn, discobox_head.py:261-285).
    mu (B, N); nu (B, M); cost (B, N, M). Returns the transport (B, N, M)."""
    k = torch.exp(-cost / reg)
    u = torch.ones_like(mu) / mu.shape[1]
    v = torch.ones_like(nu) / nu.shape[1]
    for _ in range(num_iters):
        ktu = torch.einsum('bnm,bn->bm', k, u)
        v = nu / torch.clamp(ktu, min=1e-12)
        kv = torch.einsum('bnm,bm->bn', k, v)
        u = 1.0 / torch.clamp(kv / torch.clamp(mu, min=1e-12), min=1e-12)
    return u[:, :, None] * k * v[:, None, :]


@functools.lru_cache(maxsize=None)
def _vote_counts(h: int, w: int) -> np.ndarray:
    """(h, w, h, w) number of the 9 shared displacements that stay inside
    both maps, at least 1."""
    iy = np.arange(h)
    ix = np.arange(w)
    cnt = np.zeros((h, w, h, w), np.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            oy = (iy - dy >= 0) & (iy - dy < h)
            ox = (ix - dx >= 0) & (ix - dx < w)
            cnt += (oy[:, None, None, None] & ox[None, :, None, None]
                    & oy[None, None, :, None] & ox[None, None, None, :])
    return np.maximum(cnt, 1.0)


def pass_message(t: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Diagonal 3x3 neighbourhood voting (reference pass_message,
    discobox_head.py:349-367): T'(s + d, t + d) averages T(s, t) over the
    9 shared displacements d, zero outside. t (B, N, N) with N = h * w."""
    h, w = shape
    b = t.shape[0]
    pad = F.pad(t.reshape(b, h, w, h, w), (1, 1) * 4)
    acc = torch.zeros((b, h, w, h, w), dtype=t.dtype, device=t.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + pad[:, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w,
                            1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
    cnt = torch.from_numpy(_vote_counts(h, w)).to(t)
    return (acc / cnt).reshape(b, h * w, h * w)


@functools.lru_cache(maxsize=None)
def _dist_mask(h: int, w: int, dist_kernel: int) -> np.ndarray:
    """(N, N) mask: 1 where two cells lie within the kernel's window (a max
    pool of the identity, padded with -inf as ``reduce_window`` is)."""
    n = h * w
    eye = torch.eye(n).reshape(n, 1, h, w)
    pooled = F.max_pool2d(eye, dist_kernel, 1, dist_kernel // 2)
    return pooled.reshape(n, n).T.contiguous().numpy()


def solve_correspondence(q_feat: torch.Tensor, k_feat: torch.Tensor,
                         feat_hw: Tuple[int, int], num_iter: int = 10,
                         num_smooth_iter: int = 1, dist_kernel: int = 9
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Regularised Hough matching (reference solve, discobox_head.py:
    369-411). q_feat, k_feat (B, N, C). Returns (Cu, T), both (B, N, N):
    the raw cosine similarity (differentiable in both features) and the
    refined assignment (no gradient)."""
    h, w = feat_hw
    qn = q_feat / (torch.linalg.vector_norm(q_feat, dim=-1, keepdim=True)
                   + 1e-4)
    kn = k_feat / (torch.linalg.vector_norm(k_feat, dim=-1, keepdim=True)
                   + 1e-4)
    cu = torch.einsum('bnc,bmc->bnm', qn, kn)
    cu_d = cu.detach()
    dist = torch.from_numpy(_dist_mask(h, w, dist_kernel)).to(cu)
    c = cu_d * dist[None]
    for _ in range(num_iter):
        votes = c
        for _ in range(num_smooth_iter):
            votes = pass_message(votes, (h, w))
            votes = votes / (votes.sum(2, keepdim=True) + 1e-4)
        c = cu_d + votes
        c = c / (c.sum(2, keepdim=True) + 1e-4)
    return cu, c


def info_nce_loss(cu: torch.Tensor, t: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of softmax(Cu) against the argmax of T (first maximum)
    (reference corr_loss body, discobox_head.py:1081-1086). cu, t
    (..., P, N, N); valid (..., P) pair validity. Returns the valid pairs'
    mean over P, shape (...)."""
    assignment = torch.argmax(t, dim=-1)
    logp = F.log_softmax(cu, dim=-1)
    ce = -torch.gather(logp, -1, assignment[..., None])[..., 0]
    per_pair = ce.mean(dim=-1)
    v = valid.to(cu.dtype)
    return (per_pair * v).sum(-1) / torch.clamp(v.sum(-1), min=1e-4)


# --------------------------------------------------------------- object bank
class ObjectBank(NamedTuple):
    """Per-class ring buffers (device tensors, updated in place)."""
    feat: torch.Tensor    # (C, L, fh, fw, D) relu + L2 normalised features
    mask: torch.Tensor    # (C, L, mh, mw)
    box: torch.Tensor     # (C, L, 4)
    ptr: torch.Tensor     # (C,) int32 next slot
    count: torch.Tensor   # (C,) int32 total appended


def create_object_bank(num_classes: int, len_queue: int, feat_hw, mask_hw,
                       feat_dim: int, device=None) -> ObjectBank:
    fh, fw = feat_hw
    mh, mw = mask_hw
    z = functools.partial(torch.zeros, device=device)
    return ObjectBank(
        feat=z((num_classes, len_queue, fh, fw, feat_dim)),
        mask=z((num_classes, len_queue, mh, mw)),
        box=z((num_classes, len_queue, 4)),
        ptr=z((num_classes,), dtype=torch.int32),
        count=z((num_classes,), dtype=torch.int32))


@torch.no_grad()
def bank_append(bank: ObjectBank, labels: torch.Tensor, feats: torch.Tensor,
                masks: torch.Tensor, boxes: torch.Tensor,
                valid: torch.Tensor) -> ObjectBank:
    """Append the valid ones of K objects in order, in place (reference
    ObjectQueues.append, discobox_head.py:145-171; the JAX package writes
    them one after the other in a loop).

    labels (K,); feats (K, fh, fw, D); masks (K, mh, mw); boxes (K, 4);
    valid (K,). Without a host sync: a valid item's rank among the earlier
    valid items of its class puts it at (ptr[cls] + rank) % L; an invalid
    item writes its slot's own content back, at a slot after every valid
    one of its class, so no two items share a slot. That is the loop's
    result while one call holds fewer than L items, which is checked."""
    n_cls, length = bank.feat.shape[:2]
    k = labels.shape[0]
    if k >= length:
        raise ValueError(f'{k} objects in one append: the ring buffers hold '
                         f'{length}, so a class could wrap within the call')
    lab = labels.long()
    v = valid.bool()
    onehot = lab[:, None] == torch.arange(n_cls, device=lab.device)
    ohv = (onehot & v[:, None]).long()
    ohi = (onehot & ~v[:, None]).long()
    rank_v = (ohv.cumsum(0) - ohv).gather(1, lab[:, None])[:, 0]
    rank_i = (ohi.cumsum(0) - ohi).gather(1, lab[:, None])[:, 0]
    added = ohv.sum(0)
    rank = torch.where(v, rank_v, added[lab] + rank_i)
    flat = lab * length + (bank.ptr.long()[lab] + rank) % length
    for buf, new in ((bank.feat, feats), (bank.mask, masks),
                     (bank.box, boxes)):
        rows = buf.view(n_cls * length, -1)
        keep = torch.where(v[:, None], new.reshape(k, -1).to(rows.dtype),
                           rows[flat])
        rows.index_copy_(0, flat, keep)
    bank.ptr.copy_(((bank.ptr.long() + added) % length).to(bank.ptr.dtype))
    bank.count.add_(added.to(bank.count.dtype))
    return bank


def bank_retrieve_batch(bank: ObjectBank, labels: torch.Tensor,
                        q_feat: torch.Tensor, q_mask: torch.Tensor,
                        q_box: torch.Tensor, fg_iou_thresh: float = 0.7,
                        bg_iou_thresh: float = 0.7,
                        appear_thresh: float = 0.7, ratio_range=(0.9, 1.2),
                        max_retrieval: int = 5
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Retrieve up to ``max_retrieval`` similar same-class objects for each
    of Q queries (reference get_similar_obj, discobox_head.py:205-227).

    labels (Q,); q_feat (Q, fh, fw, D); q_mask (Q, mh, mw); q_box (Q, 4).
    Returns (feats (Q, R, fh, fw, D), masks (Q, R, mh, mw), valid (Q, R)).
    The masks are compared with the bank's at the feature size through the
    counterpart of ``jax.image.resize``, antialiasing included."""
    n_cls, length, fh, fw, d = bank.feat.shape
    mh, mw = bank.mask.shape[2:]
    q = labels.shape[0]
    dev = bank.feat.device
    lab = labels.long()
    rows = (lab[:, None] * length
            + torch.arange(length, device=dev)[None, :]).reshape(-1)
    kf = bank.feat.reshape(n_cls * length, -1)[rows].reshape(
        q, length, fh, fw, d)
    km = bank.mask.reshape(n_cls * length, -1)[rows].reshape(
        q, length, mh, mw)
    kb = bank.box.reshape(n_cls * length, 4)[rows].reshape(q, length, 4)
    filled = torch.arange(length, device=dev)[None, :] < torch.clamp(
        bank.count.long()[lab], max=length)[:, None]

    qm = q_mask[:, None]
    fg_iou = (qm * km).sum((2, 3)) / torch.clamp(
        ((qm + km) >= 1).sum((2, 3)).to(km.dtype), min=1e-6)
    bg_iou = ((1 - qm) * (1 - km)).sum((2, 3)) / torch.clamp(
        ((2 - qm - km) >= 1).sum((2, 3)).to(km.dtype), min=1e-6)

    qm_f = resize_bilinear_antialias(q_mask, (fh, fw))
    km_f = resize_bilinear_antialias(km, (fh, fw))
    sim = (q_feat[:, None] * kf * qm_f[:, None, ..., None]
           * km_f[..., None]).sum((2, 3, 4)) / torch.clamp(
        (qm_f[:, None] * km_f).sum((2, 3)), min=1e-6)

    q_ratio = (q_box[:, 2] - q_box[:, 0]) / (q_box[:, 3] - q_box[:, 1]
                                             + 1e-5)
    k_ratio = (kb[..., 2] - kb[..., 0]) / (kb[..., 3] - kb[..., 1] + 1e-5)
    ratio = q_ratio[:, None] / torch.clamp(k_ratio, min=1e-5)

    ok = (filled & (fg_iou > fg_iou_thresh) & (bg_iou > bg_iou_thresh)
          & (sim > appear_thresh) & (ratio >= ratio_range[0])
          & (ratio <= ratio_range[1]))
    idx = torch.arange(length, device=dev)[None, :]
    key = torch.where(ok, idx, length + idx)
    order = torch.argsort(key, dim=1)[:, :max_retrieval]         # (Q, R)
    valid = torch.gather(ok, 1, order)
    sel = (torch.arange(q, device=dev)[:, None] * length + order).reshape(-1)
    kf_sel = kf.reshape(q * length, -1)[sel].reshape(q, -1, fh, fw, d)
    km_sel = km.reshape(q * length, -1)[sel].reshape(q, -1, mh, mw)
    return kf_sel, km_sel, valid


def bank_retrieve(bank: ObjectBank, label: torch.Tensor,
                  q_feat: torch.Tensor, q_mask: torch.Tensor,
                  q_box: torch.Tensor, **kwargs
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``bank_retrieve_batch`` for one query: label (), q_feat (fh, fw, D),
    q_mask (mh, mw), q_box (4,). Returns (feats (R, fh, fw, D), masks
    (R, mh, mw), valid (R,))."""
    kf, km, valid = bank_retrieve_batch(
        bank, label.reshape(1), q_feat[None], q_mask[None], q_box[None],
        **kwargs)
    return kf[0], km[0], valid[0]
