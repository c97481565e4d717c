"""Linear sum assignment (exact Jonker-Volgenant) on the device: the plain
PyTorch version and the CUDA kernel (``csrc/lsa.cu``).

Counterpart of ``solve_lsa`` (``boxinstseg_tpu/ops/lsa.py``), the solver of
the mask-transformer Hungarian match (reference:
mmdet/core/bbox/assigners/mask_hungarian_assigner.py:113-123, which solves
with scipy on the host). Both versions run the JAX algorithm step for step
so that exactly tied costs resolve as they do there:

- the shortest augmenting path with row potentials u and column potentials
  v; rows are augmented in order 0 .. n_rows - 1;
- a step relaxes every unused column through the row being explored
  (``cur = (cost[i0, j] - u[i0]) - v[j]``, fp32), takes the tightest
  unused column (the lowest index on ties, as ``jnp.argmin``), adds delta
  to row i and to the rows owning used columns, takes it from the used
  columns' v and from the unused columns' slack;
- a search ends at a free column, or after m + 1 steps;
- the back-walk then flips the path's columns.

``solve_lsa`` calls the registered torch op ``boxinstseg::solve_lsa``,
whose implementation the dispatcher picks by the device of ``cost``: the
kernel on a CUDA tensor (one thread block a problem, no host sync:
``n_rows`` is read on the device), ``solve_lsa_plain`` on a CPU tensor.
The cost takes no gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._native import check, load_library
from ..utils.profiling import count

# the unused columns' initial slack (the JAX package's _INF)
INF = 1e30
# dynamic shared memory a block may use on sm_90
MAX_SHARED_BYTES = 232448


def _n_rows(n_rows, p: int, n: int, device) -> torch.Tensor:
    if n_rows is None:
        return torch.full((p,), n, dtype=torch.int32, device=device)
    return torch.as_tensor(n_rows, device=device).to(torch.int32)


def solve_lsa_plain(cost: torch.Tensor, n_rows: Optional[torch.Tensor] = None,
                    return_steps: bool = False):
    """cost (P, n, m) with n <= m; n_rows (P,) live rows a problem (all n
    without it). Returns col4row (P, n) int64: the column of each live row,
    0 for the rows past n_rows; with ``return_steps`` also the augmenting
    steps each problem took (P,) int64.

    The JAX algorithm batched over problems: every tensor op of a step runs
    on all problems, and a problem whose search has ended keeps its state
    (``torch.where`` on a run mask)."""
    p, n, m = cost.shape
    assert n <= m, (n, m)
    dev = cost.device
    cost = cost.detach().float()
    live = _n_rows(n_rows, p, n, dev).clamp(0, n).long()
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    pidx = torch.arange(p, device=dev)
    u = torch.zeros((p, n), device=dev)
    v = torch.zeros((p, m), device=dev)
    col2row = torch.full((p, m), -1, dtype=torch.long, device=dev)
    steps_total = torch.zeros((p,), dtype=torch.long, device=dev)
    n_max = int(live.max()) if p else 0
    for i in range(n_max):
        active = i < live
        i0 = torch.full((p,), i, dtype=torch.long, device=dev)
        last_j = torch.full((p,), -1, dtype=torch.long, device=dev)
        minv = torch.full((p, m), INF, device=dev)
        way = torch.full((p, m), -1, dtype=torch.long, device=dev)
        used = torch.zeros((p, m), dtype=torch.bool, device=dev)
        j_free = torch.full((p,), -1, dtype=torch.long, device=dev)
        steps = torch.zeros((p,), dtype=torch.long, device=dev)
        while True:
            run = active & (j_free < 0) & (steps <= m)
            if not bool(run.any()):
                break
            r2 = run[:, None]
            cur = (cost[pidx, i0] - u[pidx, i0][:, None]) - v
            upd = ~used & (cur < minv) & r2
            minv = torch.where(upd, cur, minv)
            way = torch.where(upd, last_j[:, None], way)
            masked = torch.where(used, torch.full_like(minv, INF), minv)
            j1 = torch.argmin(masked, dim=1)
            delta = masked[pidx, j1]
            # rows owning a used column (a scatter into a spare slot n for
            # the rest)
            owner_slot = torch.where(used & (col2row >= 0), col2row,
                                     torch.full_like(col2row, n))
            owns = torch.zeros((p, n + 1), dtype=torch.bool, device=dev)
            owns.scatter_(1, owner_slot, True)
            gain = ((rows == i)[None, :] | owns[:, :n]).to(u.dtype)
            u = torch.where(r2, u + delta[:, None] * gain, u)
            v = torch.where(r2 & used, v - delta[:, None], v)
            minv = torch.where(r2 & ~used, minv - delta[:, None], minv)
            used = used | (r2 & (cols[None, :] == j1[:, None]))
            owner = col2row[pidx, j1]
            done = owner < 0
            i0 = torch.where(run & ~done, owner, i0)
            last_j = torch.where(run, j1, last_j)
            j_free = torch.where(run & done, j1, j_free)
            steps = steps + run.long()
        steps_total += steps
        # the back-walk, flipping column ownership along the path
        j0 = torch.where(active, j_free, torch.full_like(j_free, -1))
        while bool((j0 >= 0).any()):
            walk = j0 >= 0
            jc = j0.clamp(min=0)
            jprev = way[pidx, jc]
            prev_owner = col2row[pidx, jprev.clamp(min=0)]
            row = torch.where(jprev < 0, torch.full_like(jprev, i),
                              prev_owner)
            col2row[pidx[walk], jc[walk]] = row[walk]
            j0 = torch.where(walk, jprev, j0)
    hit = col2row[:, None, :] == rows[None, :, None]            # (P, n, m)
    col4row = (hit.long() * cols).sum(dim=2)
    return (col4row, steps_total) if return_steps else col4row


# ------------------------------------------------------------ CUDA kernel

def shared_bytes(n: int, m: int) -> int:
    """Shared memory of one problem's block: the cost, u, and per column
    v, minv, way, col2row (4 bytes each) and used (1 byte)."""
    return 4 * n * m + 4 * n + 17 * m


@functools.lru_cache(maxsize=None)
def _lib():
    """Build (first call) and type the C interface of csrc/lsa.cu."""
    lib = load_library('lsa')
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lsa_solve.argtypes = [p, p, p, p, i, i, i, p]
    lib.lsa_solve.restype = i
    return lib


def _check_inputs(cost, n_rows):
    if not cost.is_cuda:
        raise ValueError('cost must be a CUDA tensor')
    if cost.dtype != torch.float32:
        raise ValueError(f'cost must be float32, got {cost.dtype}')
    if cost.dim() != 3 or not cost.is_contiguous():
        raise ValueError(f'cost {tuple(cost.shape)} must be a contiguous '
                         f'(P, n, m)')
    p, n, m = cost.shape
    if n > m:
        raise ValueError(f'{n} rows > {m} columns: every row is assigned')
    if n_rows.device != cost.device or n_rows.dtype != torch.int32 or \
            tuple(n_rows.shape) != (p,):
        raise ValueError(f'n_rows must be a ({p},) int32 tensor on '
                         f'{cost.device}')
    if shared_bytes(n, m) > MAX_SHARED_BYTES:
        raise ValueError(f'a {n}x{m} problem needs {shared_bytes(n, m)} '
                         f'bytes of shared memory; the kernel takes at '
                         f'most {MAX_SHARED_BYTES}')
    if p > 2 ** 31 - 1:
        raise ValueError('too many problems for one launch')


def solve_lsa_cuda(cost: torch.Tensor, n_rows: torch.Tensor,
                   steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel: col4row (P, n) int64 of a contiguous fp32 (P, n, m)
    cost with n_rows (P,) int32 on the same card; ``steps``, a (P,) int32
    tensor when given, receives each problem's augmenting steps."""
    _check_inputs(cost, n_rows)
    p, n, m = cost.shape
    out = torch.empty((p, n), dtype=torch.int64, device=cost.device)
    if p == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    with torch.cuda.device(cost.device):
        err = _lib().lsa_solve(
            cost.data_ptr(), n_rows.data_ptr(), out.data_ptr(),
            steps.data_ptr() if steps is not None else None, p, n, m,
            stream)
    check(err, 'lsa_solve')
    count('kernel.lsa')
    return out


# --------------------------------------------------- registered torch op

def _check_layout(cost, n_rows):
    """The shapes and types the op takes; no device or stride check, so it
    also runs on fake tensors."""
    if cost.dtype != torch.float32 or cost.dim() != 3:
        raise ValueError(f'cost must be a float32 (P, n, m), got '
                         f'{cost.dtype} {tuple(cost.shape)}')
    p, n, m = cost.shape
    if n > m:
        raise ValueError(f'{n} rows > {m} columns: every row is assigned')
    if n_rows.dtype != torch.int32 or tuple(n_rows.shape) != (p,):
        raise ValueError(f'n_rows must be a ({p},) int32 tensor')


@torch.library.custom_op('boxinstseg::solve_lsa', mutates_args=(),
                         device_types='cuda')
def solve_lsa_op(cost: torch.Tensor, n_rows: torch.Tensor) -> torch.Tensor:
    """The LSA kernel as a torch op: col4row (P, n) int64 of the fp32 cost
    (P, n, m) with ``n_rows`` (P,) int32 live rows a problem, a tensor
    read on the device. No gradient. No flop formula is registered: the
    work is the augmenting steps, which depend on the costs, not on the
    shapes."""
    return solve_lsa_cuda(cost, n_rows)


@solve_lsa_op.register_kernel('cpu')
def _solve_lsa_cpu(cost, n_rows):
    _check_layout(cost, n_rows)
    return solve_lsa_plain(cost, n_rows)


@solve_lsa_op.register_fake
def _solve_lsa_fake(cost, n_rows):
    _check_layout(cost, n_rows)
    p, n, _ = cost.shape
    return cost.new_empty((p, n), dtype=torch.int64)


def solve_lsa(cost: torch.Tensor, n_rows=None) -> torch.Tensor:
    """Assign each of the first ``n_rows`` rows of every (n, m) problem of
    ``cost`` (P, n, m) (or one (n, m) problem) a distinct column at the
    least total cost. Returns col4row (P, n) (or (n,)) int64, 0 past
    n_rows. Calls the op ``boxinstseg::solve_lsa``: the kernel for a CUDA
    tensor (which raises on what it does not take), the plain version for
    a CPU tensor."""
    single = cost.dim() == 2
    c = cost.detach()[None] if single else cost.detach()
    p, n, m = c.shape
    assert n <= m, (n, m)
    if c.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'no LSA solver for device {c.device}')
    nr = _n_rows(n_rows, p, n, c.device).reshape(p)
    out = solve_lsa_op(c.float().contiguous(), nr.contiguous())
    return out[0] if single else out
