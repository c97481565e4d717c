"""Data parallelism across processes, the counterpart of
``boxinstseg_tpu/parallel/mesh.py`` and of the global-batch arithmetic the
JAX package gets from one ``jit`` over its data mesh.

Each process (rank) trains on a contiguous slice of the global batch
(``data.loader.TrainLoader``). The port then computes what one process
would compute on the whole global batch:

- every batch-wide normaliser follows mmdet's ``reduce_mean`` convention
  (``reduce_mean_denominator``): the denominator is ``clamp(sum over ranks,
  min) / world``, the rank's loss keeps its local numerator, so the mean of
  the ranks' losses is the global-batch loss;
- ``SyncBatchNorm`` takes the global batch's moments through the
  differentiable all-reduce, so its backward is global too;
- the gradients are averaged (``average_gradients``, one flat all-reduce a
  bucket) before the clip and the optimizer step.

The helpers use only ``all_reduce``, ``broadcast`` and ``barrier``, which
gloo also takes on CUDA tensors: one code path serves nccl on cards, gloo
on the CPU and gloo with several ranks on one card. Without a process group
(one process, not launched) every helper is the identity and issues no
collective.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as tdist

BUCKET_BYTES = 25 * 1024 * 1024      # gradient bucket, as torch DDP's


def is_distributed() -> bool:
    """Whether a process group is initialised."""
    return tdist.is_available() and tdist.is_initialized()


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout: Optional[timedelta] = None) -> bool:
    """Join the process group of a launched run.

    Explicit arguments, or the environment that ``torchrun`` sets: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.
    Returns False, and issues no collective, when neither gives a world
    size (one process, not launched). A launched world of one still forms
    its group, so its collective path runs. ``backend`` is ``nccl`` (the
    default; one card a rank, ``cuda:{LOCAL_RANK}``) or ``gloo`` (the CPU,
    or several ranks on one card); it is never switched."""
    env = os.environ
    if world_size is None and env.get('WORLD_SIZE'):
        world_size = int(env['WORLD_SIZE'])
    if rank is None and env.get('RANK'):
        rank = int(env['RANK'])
    if not world_size:
        return False
    if rank is None:
        raise ValueError('a world size was given but no rank')
    backend = backend or 'nccl'
    if backend == 'nccl':
        if not torch.cuda.is_available():
            raise RuntimeError('backend nccl: no CUDA device is available')
        torch.cuda.set_device(local_rank())
    elif backend != 'gloo':
        raise ValueError(f'unknown backend {backend}')
    if init_method is None:
        if not (env.get('MASTER_ADDR') and env.get('MASTER_PORT')):
            raise ValueError('no init_method and no MASTER_ADDR / '
                             'MASTER_PORT in the environment')
        init_method = f'tcp://{env["MASTER_ADDR"]}:{env["MASTER_PORT"]}'
    kwargs = {} if timeout is None else dict(timeout=timeout)
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=world_size, rank=rank, **kwargs)
    return True


def destroy() -> None:
    """Leave the process group, if there is one."""
    if is_distributed():
        tdist.destroy_process_group()


def rank() -> int:
    return tdist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return tdist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    """``LOCAL_RANK`` of the environment (0 when unset)."""
    return int(os.environ.get('LOCAL_RANK', 0))


def local_device() -> torch.device:
    """This rank's card, ``cuda:{LOCAL_RANK}``; raises without one (a CPU
    run passes its device explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError('local_device: no CUDA device is available')
    return torch.device('cuda', local_rank())


def collective_device() -> torch.device:
    """Where a tensor made for a collective lives: this rank's card under
    nccl (which takes no CPU tensor), the CPU under gloo."""
    if is_distributed() and tdist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def barrier() -> None:
    if not is_distributed():
        return
    if tdist.get_backend() == 'nccl':
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()


def broadcast_state(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` from rank 0, in place."""
    if not is_distributed():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            tdist.broadcast(t.data, src=0)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``t`` (a new tensor; no gradient)."""
    if not is_distributed():
        return t
    out = t.detach().clone()
    tdist.all_reduce(out)
    return out


def all_reduce_sum_autograd(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``t``, differentiable: its backward sums the
    ranks' output gradients, so each rank's input gets the gradient of the
    sum of all ranks' losses."""
    if not is_distributed():
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t)


def reduce_mean_denominator(x: torch.Tensor,
                            clamp_min: Optional[float] = None,
                            offset: float = 0.0) -> torch.Tensor:
    """A batch-wide normaliser under mmdet's ``reduce_mean`` convention:
    ``clamp(sum over ranks of x + offset, clamp_min) / world``. The rank's
    loss divides its local numerator by it; the mean over ranks is then
    the global batch's ``sum(num) / clamp(sum(x) + offset, clamp_min)``.
    One process: ``clamp(x + offset, clamp_min)``, as before."""
    total = all_reduce_sum(x.detach()) if is_distributed() else x
    if offset:
        total = total + offset
    if clamp_min is not None:
        total = torch.clamp(total, min=clamp_min)
    return total / world_size() if is_distributed() else total


def all_gather_fixed(t: torch.Tensor) -> torch.Tensor:
    """(world, *t.shape): every rank's ``t`` in rank order, as an
    all-reduce of a zero-filled buffer with this rank's slot written (so
    the values are exact). One process: ``t[None]``."""
    if not is_distributed():
        return t[None]
    src = t.detach()
    dtype = src.dtype
    if dtype == torch.bool:
        src = src.to(torch.uint8)
    buf = torch.zeros((world_size(),) + tuple(src.shape), dtype=src.dtype,
                      device=src.device)
    buf[rank()] = src
    tdist.all_reduce(buf)
    return buf.to(dtype)


def average_gradients(grads: Iterable[torch.Tensor],
                      bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each gradient by its mean over ranks, in place: one flat
    all-reduce for each bucket of up to ``bucket_bytes`` of one dtype and
    device."""
    if not is_distributed():
        return
    n = world_size()
    buckets: Dict[tuple, List[List[torch.Tensor]]] = {}
    for g in grads:
        key = (g.dtype, g.device)
        lists = buckets.setdefault(key, [[]])
        size = sum(x.numel() * x.element_size() for x in lists[-1])
        if lists[-1] and size + g.numel() * g.element_size() > bucket_bytes:
            lists.append([])
        lists[-1].append(g)
    for lists in buckets.values():
        for bucket in lists:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            tdist.all_reduce(flat)
            flat.div_(n)
            offset = 0
            for g in bucket:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()


def mean_over_ranks(values: Dict[str, object]) -> Dict[str, object]:
    """The mean over ranks of each value (0-dim tensors or numbers), as
    floats, in one all-reduce on the device of the first tensor: the read
    of a logged step's losses. One process: ``values`` as given."""
    if not is_distributed():
        return values
    keys = sorted(values)
    device = next((v.device for v in values.values()
                   if torch.is_tensor(v)), torch.device('cpu'))
    vec = torch.stack([torch.as_tensor(values[k], dtype=torch.float64)
                       .to(device).reshape(()) for k in keys])
    tdist.all_reduce(vec)
    return dict(zip(keys, (vec / world_size()).tolist()))


def max_reducer():
    """``f(ints) -> their element-wise max over ranks`` (an int64 numpy
    array) on a gloo group of its own, so that a thread beside the training
    loop (the loader's producer) can call it while the loop issues the main
    group's collectives; None without a process group. Every rank calls
    this at the same point of its program."""
    if not is_distributed():
        return None
    group = tdist.new_group(backend='gloo')

    def reduce_max(values):
        t = torch.as_tensor(values, dtype=torch.int64).clone()
        tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=group)
        return t.numpy()

    return reduce_max
