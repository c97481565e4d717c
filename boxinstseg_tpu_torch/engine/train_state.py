"""Train step, counterpart of ``boxinstseg_tpu/engine/train_state.py``
``make_train_step``: loss, gradients, the LR of this step and the SGD
update, with the BoxInst warmup counter equal to the step count BEFORE the
update (reference: the ``_iter`` buffer, condinst_head.py:1104,1331).
Each parameter group's LR is the scheduled LR times its ``lr_mult``
(``engine.optimizers``), as optax scales a paramwise update.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    lr_fn: Callable[[int], float],
                    grad_clip: Optional[dict] = None) -> Callable:
    """Build ``train_step(batch, step) -> logs``.

    The total loss sums every key that contains 'loss' (reference
    _parse_losses, base.py:176-254). Parameters that got no gradient (the
    frozen backbone stages, cut from autograd) get a zero gradient, so
    SGD's weight decay and momentum move them as optax moves every leaf of
    the JAX param tree. ``logs`` holds detached 0-dim tensors: every loss,
    'loss' (the total), 'grad_norm' (global L2 norm of the gradients,
    before clipping) and 'lr' (the scheduled LR, before ``lr_mult``).
    """
    params = [p for group in optimizer.param_groups for p in group['params']]
    max_norm = float(grad_clip['max_norm']) if grad_clip else None

    def train_step(batch: Dict[str, torch.Tensor], step: int
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        losses = model.loss(batch, step)
        total = sum(v for k, v in losses.items() if 'loss' in k)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if max_norm is not None:
            torch.nn.utils.clip_grad_norm_(params, max_norm)
        lr = lr_fn(step)
        for group in optimizer.param_groups:
            group['lr'] = lr * group['lr_mult']
        optimizer.step()
        logs = {k: v.detach() for k, v in losses.items()}
        logs['loss'] = total.detach()
        logs['grad_norm'] = grad_norm.detach()
        logs['lr'] = torch.tensor(lr)
        return logs

    return train_step
