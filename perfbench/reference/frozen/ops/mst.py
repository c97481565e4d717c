"""Frozen copy: the plain version alone, which the public entry at the
end of this file calls. Minimum spanning tree of the 4-connected pixel grid, rooted at node 0:
the plain PyTorch version and the CUDA kernel (``csrc/mst.cu``).

Counterpart of ``boxinstseg_tpu/ops/mst.py`` ``grid_mst_device`` (plain
XLA there, not a Pallas kernel), the tree of the tree filter that
BoxLevelset and Box2Mask train through (reference: mmdet/ops/tree_filter,
a CPU Boruvka, then a BFS on the GPU).

The JAX package picks edges in the total order (weight, edge index), with
the edges laid out as ``grid_edges`` gives them (the h*(w-1) right edges
row-major, then the (h-1)*w down edges): a stable argsort of the weights,
in which -0.0 equals 0.0 and every NaN sorts last. Under a total order the
minimum spanning tree is unique, and so are the parent and depth of every
node once the tree is rooted at node 0 (the root is its own parent at
depth 0). Nodes deeper than ``max_depth`` are detached: each becomes its
own root at depth 0. Both versions here give exactly that answer; neither
copies the JAX package's TPU layout (packed pointer tables, f32 rank
tables). They order the edges by one int64 key each, an order-preserving
integer of the fp32 weight in the high 32 bits and the edge's index in
the low 32 (``order_keys``), so a minimum of keys is the JAX order's
minimum with no sort.

- ``grid_mst_plain``: batched Boruvka (a scatter-min of the keys per
  component, hooking to the partner, mutual pairs broken to the smaller
  label, pointer jumping, an early exit when no live edge is left), then a
  level-synchronous BFS from node 0 that stops after ``max_depth`` levels.
  Tensor ops only, on any device.
- ``grid_mst_cuda``: the kernel, one thread block a tree, the tree's
  labels, per-component minima and chosen edges in shared memory.

``grid_mst`` calls the registered torch op ``boxinstseg::grid_mst``, whose
implementation the dispatcher picks by the device of the weights: the
kernel on a CUDA tensor (no host copy, no sync), the plain version on a
CPU tensor. The weights take no gradient.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


# dynamic shared memory a block may use on sm_90
MAX_SHARED_BYTES = 232448
# shared bytes a node: its label (4), its component's least key (8), its
# right and down edges' chosen flags (1 + 1); the block's static shared
# memory (12 bytes) takes from the same 227 KB
SHARED_BYTES_PER_NODE = 14
MAX_NODES = (MAX_SHARED_BYTES - 64) // SHARED_BYTES_PER_NODE
_NO_KEY = torch.iinfo(torch.int64).max


@functools.lru_cache(maxsize=None)
def grid_edges(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static (src, dst) node ids of the 4-connected h x w grid: first the
    (h, w-1) right edges, then the (h-1, w) down edges."""
    idx = np.arange(h * w, dtype=np.int64).reshape(h, w)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return src, dst


def order_keys(weights: torch.Tensor) -> torch.Tensor:
    """(..., E) fp32 edge weights -> (..., E) int64 keys that order as
    (weight, edge index) does: -0.0 counts as 0.0, every NaN above +inf.
    The weight's bits become an order-preserving int32 (a negative weight's
    magnitude bits flipped), which fills the high 32 bits; the edge's index
    along the last axis fills the low 32. ``csrc/mst.cu`` builds the same
    keys, unsigned."""
    w = weights.float()
    w = torch.where(w == 0, torch.zeros_like(w), w)
    bits = w.contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    bits = torch.where(torch.isnan(w), torch.full_like(bits, 0x7FFFFFFF),
                       bits)
    idx = torch.arange(w.shape[-1], dtype=torch.int64, device=w.device)
    return bits.long() * (1 << 32) + idx


def _rounds(n: int) -> int:
    return max(int(math.ceil(math.log2(max(n, 2)))), 1)


def boruvka_plain(w_right: torch.Tensor, w_down: torch.Tensor
                  ) -> torch.Tensor:
    """(B, E) bool tree edges (``grid_edges`` layout) of each tree, all
    trees as one flat block-diagonal graph. A round: each component's
    least key over its live edges (a scatter-min), each component hooked to
    the component across that edge, mutual pairs broken to the smaller
    label, then pointer jumping (ceil(log2 N) jumps make it exact)."""
    b, h, wm1 = w_right.shape
    w = wm1 + 1
    n = h * w
    dev = w_right.device
    keys = order_keys(torch.cat([w_right.reshape(b, -1),
                                 w_down.reshape(b, -1)], dim=1))
    e = keys.shape[1]
    src, dst = (torch.as_tensor(a, device=dev) for a in grid_edges(h, w))
    offs = torch.arange(b, device=dev)[:, None] * n
    gsrc, gdst = (src + offs).reshape(-1), (dst + offs).reshape(-1)
    keys = keys.reshape(-1)
    nodes = torch.arange(b * n, device=dev)
    lbl = nodes.clone()
    chosen = torch.zeros(b * e, dtype=torch.bool, device=dev)
    jumps = _rounds(n)
    for _ in range(_rounds(n)):
        ls, ld = lbl[gsrc], lbl[gdst]
        live = ls != ld
        if not bool(live.any()):
            break
        k = torch.where(live, keys, torch.full_like(keys, _NO_KEY))
        least = torch.full((b * n,), _NO_KEY, dtype=torch.int64, device=dev)
        least.scatter_reduce_(0, ls, k, 'amin')
        least.scatter_reduce_(0, ld, k, 'amin')
        has = least != _NO_KEY
        edge = (nodes // n) * e + (least & 0xFFFFFFFF)
        edge = torch.where(has, edge, torch.zeros_like(edge))
        chosen[edge[has]] = True
        partner = torch.where(has, lbl[gsrc[edge]] + lbl[gdst[edge]] - nodes,
                              nodes)
        mutual = partner[partner] == nodes
        ptr = torch.where(mutual & (nodes < partner), nodes, partner)
        for _ in range(jumps):
            ptr = ptr[ptr]
        lbl = ptr[lbl]
    return chosen.reshape(b, e)


def root_bfs_plain(chosen: torch.Tensor, h: int, w: int, max_depth: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(parent, depth), (B, H*W) int64 each, of (B, E) tree edges rooted at
    each tree's node 0 by a level-synchronous BFS: level d gives each tree
    neighbour of a level d-1 node (but its parent) that node as parent and
    depth d. It stops after ``max_depth`` levels, so the deeper nodes stay
    their own parents at depth 0."""
    b, e = chosen.shape
    n = h * w
    n_right = h * (w - 1)
    dev = chosen.device
    ch_r = chosen[:, :n_right].reshape(b, h, w - 1)
    ch_d = chosen[:, n_right:].reshape(b, h - 1, w)
    no_c = torch.zeros((b, h, 1), dtype=torch.bool, device=dev)
    no_r = torch.zeros((b, 1, w), dtype=torch.bool, device=dev)
    exists = torch.stack([torch.cat([no_c, ch_r], 2),      # left
                          torch.cat([ch_r, no_c], 2),      # right
                          torch.cat([no_r, ch_d], 1),      # up
                          torch.cat([ch_d, no_r], 1)],     # down
                         dim=-1).reshape(b * n, 4)
    nodes = torch.arange(b * n, device=dev)
    step = torch.tensor([-1, 1, -w, w], device=dev)
    nbr = torch.where(exists, nodes[:, None] + step, -1)
    parent = nodes.clone()
    depth = torch.zeros(b * n, dtype=torch.int64, device=dev)
    frontier = nodes[::n]
    for d in range(1, max(min(max_depth, n - 1), 0) + 1):
        cand = nbr[frontier]
        ok = (cand >= 0) & (cand != parent[frontier][:, None])
        v = cand[ok]
        if v.numel() == 0:
            break
        parent[v] = frontier[:, None].expand_as(cand)[ok]
        depth[v] = d
        frontier = v
    return parent.reshape(b, n) - nodes[::n][:, None], depth.reshape(b, n)


def grid_mst_plain(w_right: torch.Tensor, w_down: torch.Tensor,
                   max_depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """w_right (B, H, W-1), w_down (B, H-1, W) edge weights -> (parent,
    depth), (B, H*W) int64 each, on the weights' device."""
    h = w_right.shape[1]
    w = w_right.shape[2] + 1
    chosen = boruvka_plain(w_right.detach(), w_down.detach())
    return root_bfs_plain(chosen, h, w, int(max_depth))


def grid_mst(w_right, w_down, max_depth):
    """w_right (B, H, W-1), w_down (B, H-1, W) edge weights ->
    (parent, depth), (B, H*W) int64 each, by the plain Boruvka and BFS."""
    return grid_mst_plain(w_right.detach().float().contiguous(),
                          w_down.detach().float().contiguous(),
                          int(max_depth))
