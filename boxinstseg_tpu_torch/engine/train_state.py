"""Train steps, counterparts of ``boxinstseg_tpu/engine/train_state.py``
``make_train_step`` and ``make_ts_train_step``: loss, gradients, the LR of
this step and the optimizer update, with the BoxInst warmup counter equal
to the step count BEFORE the update (reference: the ``_iter`` buffer,
condinst_head.py:1104,1331). Each parameter group's LR is the scheduled LR
times its ``lr_mult`` (``engine.optimizers``), as optax scales a paramwise
update. The teacher-student step adds DiscoBox's EMA teacher, its
``avg_loss_ins`` gates and the object bank.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..parallel import dist as pdist
from ..utils.profiling import span


def _make_update(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 lr_fn: Callable[[int], float],
                 grad_clip: Optional[dict] = None) -> Callable:
    """``update(total, step) -> (grad_norm, lr)``: backward of ``total``,
    zero gradients for the parameters that got none, the mean of the
    gradients over ranks under a process group (one flat all-reduce a
    bucket, ``parallel.dist.average_gradients``), the global norm,
    clipping, the scheduled LR and the optimizer step. So the norm and the
    clip see the global batch's gradient, as inside the JAX step."""
    params = [p for group in optimizer.param_groups for p in group['params']]
    max_norm = float(grad_clip['max_norm']) if grad_clip else None

    def update(total: torch.Tensor, step: int):
        with span('backward'):
            optimizer.zero_grad(set_to_none=True)
            total.backward()
        with span('grad_norm'):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            pdist.average_gradients(grads)
            grad_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            if max_norm is not None:
                torch.nn.utils.clip_grad_norm_(params, max_norm)
        with span('optimizer'):
            lr = lr_fn(step)
            for group in optimizer.param_groups:
                group['lr'] = lr * group['lr_mult']
            optimizer.step()
        return grad_norm, lr

    return update


def autocast_bf16(device: torch.device, enabled: bool):
    """The bf16 policy around a forward: convolutions and matrix products
    in bf16 under autocast; parameters, optimizer state and the losses stay
    fp32 (the detectors cast the heads' outputs at the loss boundary)."""
    return torch.autocast(torch.device(device).type, dtype=torch.bfloat16,
                          enabled=enabled)


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    lr_fn: Callable[[int], float],
                    grad_clip: Optional[dict] = None,
                    bf16: bool = False) -> Callable:
    """Build ``train_step(batch, step) -> logs``; ``bf16`` runs the forward
    and the loss under ``autocast_bf16`` (the JAX package's policy).

    The total loss sums every key that contains 'loss' (reference
    _parse_losses, base.py:176-254). Parameters that got no gradient (the
    frozen backbone stages, cut from autograd) get a zero gradient, so
    SGD's weight decay and momentum move them as optax moves every leaf of
    the JAX param tree. ``logs`` holds detached 0-dim tensors: every loss,
    'loss' (the total), 'grad_norm' (global L2 norm of the gradients,
    before clipping) and 'lr' (the scheduled LR, before ``lr_mult``).
    """
    update = _make_update(model, optimizer, lr_fn, grad_clip)

    def train_step(batch: Dict[str, torch.Tensor], step: int
                   ) -> Dict[str, torch.Tensor]:
        with span('step'):
            model.train()
            with autocast_bf16(batch['image'].device, bf16):
                losses = model.loss(batch, step)
            total = sum(v for k, v in losses.items() if 'loss' in k)
            grad_norm, lr = update(total, step)
            logs = {k: v.detach() for k, v in losses.items()}
            logs['loss'] = total.detach()
            logs['grad_norm'] = grad_norm.detach()
            logs['lr'] = torch.tensor(lr)
            return logs

    return train_step


def gather_appends(append: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The object bank's append entries of every rank: each rank's (K, ...)
    tensors gathered in rank order (the global batch's order, as the shards
    are contiguous), the valid ones first, the first K kept. Only the
    global batch's first K queries are valid, so the bank takes on every
    rank what one process would append. One process: ``append``."""
    if not pdist.is_distributed():
        return append
    keep = append['valid'].shape[0]
    every = {name: pdist.all_gather_fixed(t).flatten(0, 1)
             for name, t in append.items()}
    order = torch.argsort((~every['valid']).to(torch.uint8), stable=True)
    return {name: t[order[:keep]] for name, t in every.items()}


class TSTrainStep:
    """DiscoBox's teacher-student step, the counterpart of the JAX
    package's ``make_ts_train_step`` (reference single_stage_ts.py:
    179-237), ``step(batch, i) -> logs``. It holds:

    - ``teacher``: an EMA replica of the detector, parameters and float
      buffers; an exact copy of the student after each step before
      ``start_iter`` (momentum 0) and lagging by ``momentum`` from it on;
    - ``avg_loss_ins``: a device scalar, 2.0 at first, 0.9 / 0.1 EMA of
      loss_ins (its mean over ranks under a process group, the global
      batch's); the ``ts`` (< ts_thresh) and ``corr`` (< corr_thresh)
      gates are device tensors that multiply their terms, so nothing waits
      on the host;
    - ``bank``: the object bank (``ops.correspondence``), appended in place
      with every rank's entries (``gather_appends``), so it stays the same
      on every rank;
    - ``bf16``: the teacher's and the student's forwards and the loss run
      under ``autocast_bf16``.

    The teacher's forward runs only when ``i > start_iter``, a host integer;
    before that the detached student stands in for it, which gives the JAX
    step's values (its teacher gate is 0 there). ``teacher_forwards`` counts
    the forwards. The logs hold the losses, 'loss', 'avg_loss_ins' (before
    this step's update), 'grad_norm', 'lr' and 'teacher_forward' (1 when the
    teacher ran)."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 lr_fn: Callable[[int], float],
                 grad_clip: Optional[dict] = None, momentum: float = 0.999,
                 start_iter: int = 13000, ts_thresh: float = 0.3,
                 corr_thresh: float = 0.2, bank=None, bf16: bool = False):
        self.model = model
        self.bf16 = bool(bf16)
        self.update = _make_update(model, optimizer, lr_fn, grad_clip)
        self.teacher = copy.deepcopy(model).eval().requires_grad_(False)
        self.momentum = float(momentum)
        self.start_iter = int(start_iter)
        self.ts_thresh = ts_thresh
        self.corr_thresh = corr_thresh
        self.bank = bank
        device = next(model.parameters()).device
        self.avg_loss_ins = torch.tensor(2.0, device=device)
        self.teacher_forwards = 0
        self._params = (list(self.teacher.parameters()),
                        list(model.parameters()))
        self._buffers = tuple(
            [b for b in m.buffers() if b.is_floating_point()]
            for m in (self.teacher, model))

    @torch.no_grad()
    def _ema(self, step: int):
        # in float32 as the JAX step: m * e + (1 - m) * p, m = 0 before
        # start_iter, which makes the replica an exact copy
        m = np.float32(self.momentum if step >= self.start_iter else 0.0)
        om = float(np.float32(1.0) - m)
        for ema, cur in (self._params, self._buffers):
            torch._foreach_mul_(ema, float(m))
            torch._foreach_add_(ema, torch._foreach_mul(cur, om))

    def __call__(self, batch: Dict[str, torch.Tensor], step: int
                 ) -> Dict[str, torch.Tensor]:
        with span('step'):
            return self._step(batch, step)

    def _step(self, batch, step):
        avg = self.avg_loss_ins
        gates = dict(ts=(avg < self.ts_thresh).float(),
                     corr=(avg < self.corr_thresh).float())
        teacher_out = None
        with autocast_bf16(batch['image'].device, self.bf16):
            if step > self.start_iter:
                teacher_out = self.teacher.teacher_outputs(batch['image'])
                self.teacher_forwards += 1
            self.model.train()
            losses = self.model.loss(batch, step, teacher_out, gates,
                                     self.bank)
        append = losses.pop('_corr_append', None)
        total = sum(v for k, v in losses.items() if 'loss' in k)
        grad_norm, lr = self.update(total, step)
        with span('ema'):
            self._ema(step)
        loss_ins = losses['loss_ins'].detach()
        if pdist.is_distributed():
            loss_ins = pdist.all_reduce_sum(loss_ins) / pdist.world_size()
        self.avg_loss_ins = avg * 0.9 + 0.1 * loss_ins
        if self.bank is not None and append is not None:
            from ..ops.correspondence import bank_append
            append = gather_appends(append)
            bank_append(self.bank, append['labels'], append['feats'],
                        append['masks'], append['boxes'], append['valid'])
        logs = {k: v.detach() for k, v in losses.items()}
        logs['loss'] = total.detach()
        logs['avg_loss_ins'] = avg
        logs['grad_norm'] = grad_norm.detach()
        logs['lr'] = torch.tensor(lr)
        logs['teacher_forward'] = torch.tensor(float(teacher_out is not None))
        return logs
