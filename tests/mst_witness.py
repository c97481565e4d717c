"""scipy's minimum spanning tree of the grid, rooted at node 0: a witness
of the port's grid MST independent of both Boruvkas (not a test module).

It ranks the edges with a stable argsort (the JAX package's total order
(weight, edge index): numpy's sort also takes -0.0 as 0.0 and puts NaN
last), solves scipy's MST on the ranks, roots it with a breadth-first
order from node 0 and counts each node's depth by pointer doubling over
the parents. ``host_grid_mst`` is the path the port ran before its CUDA
kernel: the weights to the host, one scipy solve a tree, parent and depth
back to the weights' device. ``chip_smoke.py`` loads this file by path.
"""
from typing import Tuple

import numpy as np
import torch

from boxinstseg_tpu_torch.ops.mst import grid_edges


def scipy_parent_depth(weights: np.ndarray, h: int, w: int, max_depth: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """One tree's (parent, depth), (h*w,) int64 each, of its (E,) edge
    weights in ``grid_edges`` order; nodes deeper than ``max_depth`` are
    their own parents at depth 0."""
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
    # after round t, anc is the ancestor at distance min(depth, 2^t) and
    # hops that distance
    hops = (np.arange(n) != 0).astype(np.int64)
    anc = parent.copy()
    for _ in range(max(int(np.ceil(np.log2(max(n, 2)))), 1)):
        hops, anc = hops + hops[anc], anc[anc]
    depth = hops
    over = depth > max_depth
    parent[over] = np.nonzero(over)[0]
    depth[over] = 0
    return parent, depth


def host_grid_mst(w_right: torch.Tensor, w_down: torch.Tensor,
                  max_depth: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """w_right (B, H, W-1), w_down (B, H-1, W) -> (parent, depth), (B,
    H*W) int64 each, solved on the host and copied back."""
    b, h, wm1 = w_right.shape
    weights = torch.cat([w_right.reshape(b, -1), w_down.reshape(b, -1)],
                        dim=1).detach().float().cpu().numpy()
    parents, depths = zip(*(scipy_parent_depth(weights[i], h, wm1 + 1,
                                               max_depth)
                            for i in range(b)))
    dev = w_right.device
    return (torch.from_numpy(np.stack(parents)).to(dev),
            torch.from_numpy(np.stack(depths)).to(dev))
