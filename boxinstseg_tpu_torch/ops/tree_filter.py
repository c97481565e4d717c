"""Learnable tree filter, counterpart of ``boxinstseg_tpu/ops/tree_filter.py``
(reference: mmdet/ops/tree_filter, Learnable Tree Filter, NeurIPS'19).

    out_i = (1 / Z_i) * sum_j (prod_{e in path(i, j)} w_e) * f_j,
    w_e = exp(-||g_a - g_b||^2 / sigma) (sigma only for the low-level tree),
    Z_i the same aggregation of ones,

over the minimum spanning tree of the guide (``ops.mst``: on the card the
CUDA kernel of ``csrc/mst.cu``, with no copy to the host; ``grid_mst_pair``
solves both guides' trees in one launch). Both tree passes
run in ``ceil(log2(max(max_depth, 2))) + 1`` pointer-doubling rounds, as in
the JAX package, so a depth cap that binds gives the same numbers. The
indices are plain int64 (the JAX package's int32 bit-packed pointer tables
are a TPU workaround). The backward is the hand-derived O(N) one of the JAX
package's custom VJP: two more aggregation passes, no autodiff through the
rounds.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .mst import grid_mst


def _edge_weights(g: torch.Tensor):
    """Squared-difference edge weights of a (B, H, W, D) guide, summed over
    D left to right."""
    g = g.detach().float()
    dr = g[:, :, 1:] - g[:, :, :-1]
    dd = g[:, 1:] - g[:, :-1]
    wr, wd = dr[..., 0] ** 2, dd[..., 0] ** 2
    for c in range(1, g.shape[-1]):
        wr = wr + dr[..., c] ** 2
        wd = wd + dd[..., c] ** 2
    return wr, wd


def grid_mst_pair(guide_a: torch.Tensor, guide_b: torch.Tensor,
                  max_depth: int = 512):
    """The trees of two (B, H, W, D) guides in one call. Returns
    ((parent_a, depth_a), (parent_b, depth_b)), (B, H*W) int64 each."""
    wr_a, wd_a = _edge_weights(guide_a)
    wr_b, wd_b = _edge_weights(guide_b)
    parent, depth = grid_mst(torch.cat([wr_a, wr_b]),
                             torch.cat([wd_a, wd_b]), max_depth)
    b = guide_a.shape[0]
    return (parent[:b], depth[:b]), (parent[b:], depth[b:])


def _rounds(max_depth: int) -> int:
    return max(int(math.ceil(math.log2(max(max_depth, 2)))), 1) + 1


def _flat_parent(parent: torch.Tensor) -> torch.Tensor:
    b, n = parent.shape
    offs = (torch.arange(b, device=parent.device) * n)[:, None]
    return (parent + offs).reshape(-1)


def _up_pass(h, w, parent, depth, max_depth):
    """Subtree sums S_i = h_i + sum_children w_c S_c by pointer doubling.
    h (B, N, C); w (B, N) with 0 at the roots. After round t, acc_i sums
    the subtree nodes within distance < 2^t and q_i is the ancestor at
    distance 2^t (the sentinel bn once past the root), p_i the path weight
    to it."""
    b, n, c = h.shape
    bn = b * n
    sent = bn
    q = torch.where((depth > 0).reshape(-1), _flat_parent(parent),
                    torch.full((), sent, device=h.device))
    acc = h.reshape(bn, c)
    p = w.reshape(-1)
    zero = p.new_zeros(1)
    for _ in range(_rounds(max_depth)):
        acc = acc + torch.zeros((bn + 1, c), dtype=acc.dtype,
                                device=acc.device).index_add_(
            0, q, p[:, None] * acc)[:bn]
        p, q = p * torch.cat([p, zero])[q], torch.cat([q, q.new_full(
            (1,), sent)])[q]
    return acc.reshape(b, n, c)


def _down_pass(s, w, parent, depth, max_depth):
    """U_i = S_i + w_i (U_parent - w_i S_i) along root paths: the linear
    recurrence U = a + b U_parent solved by (a, b) composition doubling."""
    bsz, n, c = s.shape
    root = depth == 0
    a = torch.where(root[..., None], s, s * (1.0 - w[..., None] ** 2)
                    ).reshape(bsz * n, c)
    bb = torch.where(root, torch.zeros_like(w), w).reshape(-1)
    anc = _flat_parent(parent)
    for _ in range(_rounds(max_depth)):
        a, bb, anc = a + bb[:, None] * a[anc], bb * bb[anc], anc[anc]
    return a.reshape(bsz, n, c)


def _aggregate(h, w, parent, depth, max_depth):
    s = _up_pass(h, w, parent, depth, max_depth)
    return s, _down_pass(s, w, parent, depth, max_depth)


class TreeFilterFunction(torch.autograd.Function):
    """out = U(f) / U(1) with the analytic backward:
      df  = U(g / Z)  (the path weights are symmetric),
      dw_e (e = c -> p) = S(a)_c D(f)_p + D(a)_p S(f)_c
                          - S(b)_c D(1)_p - D(b)_p S(1)_c,
    a = g / Z, b = a * out, S the subtree (up-pass) sums and
    D(h)_p = U(h)_p - w_e S(h)_c the sum over the complement."""

    @staticmethod
    def forward(ctx, f, w, parent, depth, max_depth):
        ones = torch.ones(f.shape[:-1] + (1,), dtype=f.dtype,
                          device=f.device)
        s, u = _aggregate(torch.cat([f, ones], -1), w, parent, depth,
                          max_depth)
        z = torch.clamp(u[..., -1:], min=1e-6)
        out = u[..., :-1] / z
        ctx.save_for_backward(w, parent, depth, out, z, s, u)
        ctx.max_depth = max_depth
        return out

    @staticmethod
    def backward(ctx, g):
        w, parent, depth, out, z, s, u = ctx.saved_tensors
        c = out.shape[-1]
        a = g / z
        b = a * out
        s_ab, u_ab = _aggregate(torch.cat([a, b], -1), w, parent, depth,
                                ctx.max_depth)
        s_a, s_b = s_ab[..., :c], s_ab[..., c:]
        s_f, s_1 = s[..., :c], s[..., -1:]
        bsz, n = parent.shape
        up = torch.cat([u, u_ab], -1)                 # (B, N, 3c + 1)
        up_par = up.reshape(bsz * n, -1)[_flat_parent(parent)].reshape(
            up.shape)
        we = w[..., None]
        d_f = up_par[..., :c] - we * s_f
        d_1 = up_par[..., c:c + 1] - we * s_1
        d_a = up_par[..., c + 1:2 * c + 1] - we * s_a
        d_b = up_par[..., 2 * c + 1:] - we * s_b
        dw = (s_a * d_f + d_a * s_f - s_b * d_1 - d_b * s_1).sum(-1)
        dw = torch.where(depth == 0, torch.zeros_like(dw), dw)
        return u_ab[..., :c], dw, None, None, None


def tree_filter2d(feature: torch.Tensor, guide: torch.Tensor,
                  parent: torch.Tensor, depth: torch.Tensor,
                  sigma: float = 0.02, low_tree: bool = True,
                  max_depth: int = 512) -> torch.Tensor:
    """Filter ``feature`` (B, H, W, C) over the tree (parent, depth) with
    edge weights from ``guide`` (B, H, W, D), both differentiable.
    Returns (B, H, W, C)."""
    b, h, w_, c = feature.shape
    n = h * w_
    f = feature.reshape(b, n, c)
    g = guide.reshape(b, n, -1)
    g_par = torch.gather(g, 1, parent[..., None].expand(b, n, g.shape[-1]))
    dist = ((g - g_par) ** 2).sum(-1)
    wgt = torch.exp(-dist / sigma) if low_tree else torch.exp(-dist)
    wgt = torch.where(depth == 0, torch.zeros_like(wgt), wgt)
    out = TreeFilterFunction.apply(f, wgt, parent, depth, max_depth)
    return out.reshape(b, h, w_, c)
