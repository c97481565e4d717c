"""Minimum spanning tree of the 4-connected pixel grid, rooted at node 0:
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

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ._native import check, load_library

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


# ------------------------------------------------------------ CUDA kernel

def shared_bytes(h: int, w: int) -> int:
    """Dynamic shared memory of one tree's block (``csrc/mst.cu``)."""
    return SHARED_BYTES_PER_NODE * h * w


@functools.lru_cache(maxsize=None)
def _lib():
    """Build (first call) and type the C interface of csrc/mst.cu."""
    lib = load_library('mst')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grid_mst.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.grid_mst.restype = i
    return lib


def _check_layout(w_right, w_down):
    """The shapes and types the op takes; no device or stride check, so it
    also runs on fake tensors."""
    if w_right.dtype != torch.float32 or w_right.dim() != 3:
        raise ValueError(f'w_right must be a float32 (B, H, W-1), got '
                         f'{w_right.dtype} {tuple(w_right.shape)}')
    b, h, wm1 = w_right.shape
    if w_down.dtype != torch.float32 or \
            tuple(w_down.shape) != (b, h - 1, wm1 + 1):
        raise ValueError(f'w_down must be a float32 {(b, h - 1, wm1 + 1)}, '
                         f'got {w_down.dtype} {tuple(w_down.shape)}')


def _check_inputs(w_right, w_down):
    _check_layout(w_right, w_down)
    if not (w_right.is_cuda and w_down.device == w_right.device):
        raise ValueError('w_right and w_down must be CUDA tensors on one '
                         'card')
    if not (w_right.is_contiguous() and w_down.is_contiguous()):
        raise ValueError('w_right and w_down must be contiguous')
    b, h, wm1 = w_right.shape
    if h * (wm1 + 1) > MAX_NODES:
        raise ValueError(f'a {h}x{wm1 + 1} grid needs '
                         f'{shared_bytes(h, wm1 + 1)} bytes of shared memory'
                         f'; the kernel takes at most {MAX_NODES} nodes '
                         f'({MAX_SHARED_BYTES} bytes)')


def grid_mst_cuda(w_right: torch.Tensor, w_down: torch.Tensor,
                  max_depth: int, stats: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel: (parent, depth), (B, H*W) int64 each, of contiguous
    fp32 w_right (B, H, W-1) and w_down (B, H-1, W) on one card; ``stats``,
    a (B, 2) int32 tensor when given, receives each tree's Boruvka rounds
    and BFS levels."""
    _check_inputs(w_right, w_down)
    b, h, wm1 = w_right.shape
    n = h * (wm1 + 1)
    parent = torch.empty((b, n), dtype=torch.int64, device=w_right.device)
    depth = torch.empty_like(parent)
    if b == 0 or n == 0:
        return parent, depth
    if stats is not None and (stats.dtype != torch.int32 or
                              tuple(stats.shape) != (b, 2) or
                              stats.device != w_right.device):
        raise ValueError(f'stats must be a ({b}, 2) int32 tensor on '
                         f'{w_right.device}')
    md = max(min(int(max_depth), n), 0)
    stream = torch.cuda.current_stream(w_right.device).cuda_stream
    with torch.cuda.device(w_right.device):
        err = _lib().grid_mst(
            w_right.data_ptr(), w_down.data_ptr(), parent.data_ptr(),
            depth.data_ptr(), stats.data_ptr() if stats is not None else None,
            b, h, wm1 + 1, md, stream)
    check(err, 'grid_mst')
    grid_mst_cuda.launches += 1
    return parent, depth


grid_mst_cuda.launches = 0


# --------------------------------------------------- registered torch op

@torch.library.custom_op('boxinstseg::grid_mst', mutates_args=(),
                         device_types='cuda')
def grid_mst_op(w_right: torch.Tensor, w_down: torch.Tensor, max_depth: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid MST as a torch op: (parent, depth), (B, H*W) int64 each,
    of fp32 w_right (B, H, W-1) and w_down (B, H-1, W). No gradient."""
    return grid_mst_cuda(w_right, w_down, max_depth)


@grid_mst_op.register_kernel('cpu')
def _grid_mst_cpu(w_right, w_down, max_depth):
    _check_layout(w_right, w_down)
    return grid_mst_plain(w_right, w_down, max_depth)


@grid_mst_op.register_fake
def _grid_mst_fake(w_right, w_down, max_depth):
    _check_layout(w_right, w_down)
    b, h, wm1 = w_right.shape
    shape = (b, h * (wm1 + 1))
    return (w_right.new_empty(shape, dtype=torch.int64),
            w_right.new_empty(shape, dtype=torch.int64))


def grid_mst(w_right: torch.Tensor, w_down: torch.Tensor, max_depth: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w_right (B, H, W-1), w_down (B, H-1, W) edge weights ->
    (parent, depth), (B, H*W) int64 each, on the weights' device. Calls
    the op ``boxinstseg::grid_mst``: the kernel for CUDA tensors (which
    raises on what it does not take), the plain version for CPU tensors."""
    if w_right.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'no grid MST for device {w_right.device}')
    return grid_mst_op(w_right.detach().float().contiguous(),
                       w_down.detach().float().contiguous(), int(max_depth))
