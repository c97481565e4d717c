"""Minimum spanning tree of the 4-connected pixel grid, rooted at node 0,
counterpart of ``boxinstseg_tpu/ops/mst.py`` ``grid_mst_device``.

The JAX package's Boruvka picks edges in the total order (weight, edge
index), with the edges laid out as ``grid_edges`` gives them (the
h*(w-1) right edges row-major, then the (h-1)*w down edges). Under a
total order the minimum spanning tree is unique, so any MST algorithm run
on the edges' RANKS in that order returns the same tree. The port ranks
the edges with a stable sort and solves on the host with scipy's MST (one
device-to-host copy of the edge weights per call); a plain scipy MST on the
raw weights would break ties differently.

The tree is rooted at node 0 and every node gets its parent and depth
(the root is its own parent at depth 0). Nodes deeper than ``max_depth``
are detached: each becomes its own root at depth 0, as in the JAX package.

``grid_mst`` calls the registered torch op ``boxinstseg::grid_mst``, so
that a traced loss (``torch.export``) keeps the host solve as one node:
the host solve is its implementation on every device, and its fake gives
the (parent, depth) shapes. It is not a kernel.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def grid_edges(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static (src, dst) node ids of the 4-connected h x w grid: first the
    (h, w-1) right edges, then the (h-1, w) down edges."""
    idx = np.arange(h * w, dtype=np.int64).reshape(h, w)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return src, dst


def _mst_parent_depth(weights: np.ndarray, h: int, w: int, max_depth: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import (breadth_first_order,
                                      minimum_spanning_tree)
    n = h * w
    src, dst = grid_edges(h, w)
    rank = np.empty(len(weights), np.float64)
    rank[np.argsort(weights, kind='stable')] = np.arange(1, len(weights) + 1)
    tree = minimum_spanning_tree(coo_matrix((rank, (src, dst)),
                                            shape=(n, n)))
    _, pred = breadth_first_order(tree + tree.T, 0, directed=False,
                                  return_predecessors=True)
    parent = pred.astype(np.int64)
    parent[0] = 0
    # depth by pointer doubling: after round t, anc is the ancestor at
    # distance min(depth, 2^t) and hops that distance
    hops = (np.arange(n) != 0).astype(np.int64)
    anc = parent.copy()
    for _ in range(max(int(np.ceil(np.log2(max(n, 2)))), 1)):
        hops, anc = hops + hops[anc], anc[anc]
    depth = hops
    over = depth > max_depth
    parent[over] = np.nonzero(over)[0]
    depth[over] = 0
    return parent, depth


@torch.library.custom_op('boxinstseg::grid_mst', mutates_args=())
def grid_mst_op(w_right: torch.Tensor, w_down: torch.Tensor, max_depth: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host solve of ``grid_mst`` as a torch op."""
    b, h, wm1 = w_right.shape
    w = wm1 + 1
    weights = torch.cat([w_right.reshape(b, -1), w_down.reshape(b, -1)],
                        dim=1).detach().float().cpu().numpy()
    parents, depths = zip(*(_mst_parent_depth(weights[i], h, w, max_depth)
                            for i in range(b)))
    dev = w_right.device
    return (torch.from_numpy(np.stack(parents)).to(dev),
            torch.from_numpy(np.stack(depths)).to(dev))


@grid_mst_op.register_fake
def _grid_mst_fake(w_right, w_down, max_depth):
    b, h, wm1 = w_right.shape
    if tuple(w_down.shape) != (b, h - 1, wm1 + 1):
        raise ValueError(f'w_down {tuple(w_down.shape)} != '
                         f'{(b, h - 1, wm1 + 1)}')
    shape = (b, h * (wm1 + 1))
    return (w_right.new_empty(shape, dtype=torch.int64),
            w_right.new_empty(shape, dtype=torch.int64))


def grid_mst(w_right: torch.Tensor, w_down: torch.Tensor, max_depth: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w_right (B, H, W-1), w_down (B, H-1, W) edge weights ->
    (parent, depth), (B, H*W) int64 each, on the weights' device."""
    return grid_mst_op(w_right.detach(), w_down.detach(), int(max_depth))
