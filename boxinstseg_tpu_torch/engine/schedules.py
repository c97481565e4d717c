"""LR schedules with mmcv's LrUpdaterHook semantics, counterpart of
``boxinstseg_tpu/engine/schedules.py`` (reference: lr_config in
configs/_base_/schedules/schedule_1x.py - linear warmup + step decay)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence


def step_lr_schedule(base_lr: float,
                     warmup: Optional[str] = 'linear',
                     warmup_iters: int = 500,
                     warmup_ratio: float = 0.001,
                     step_iters: Sequence[int] = (),
                     gamma: float = 0.1) -> Callable[[int], float]:
    """Returns lr(step).

    mmcv linear warmup: lr_i = base * (1 - (1 - i/warmup_iters) *
    (1 - warmup_ratio)); afterwards base * gamma^{#passed steps}.
    ``step_iters`` are absolute iteration indices.
    """
    steps = sorted(step_iters)

    def schedule(count: int) -> float:
        if warmup == 'linear' and warmup_iters > 0 and count < warmup_iters:
            frac = min(max(count / warmup_iters, 0.0), 1.0)
            return base_lr * (1.0 - (1.0 - frac) * (1.0 - warmup_ratio))
        if warmup == 'constant' and warmup_iters > 0 \
                and count < warmup_iters:
            return base_lr * warmup_ratio
        return base_lr * gamma ** sum(count >= s for s in steps)

    return schedule


def build_lr_schedule(lr_config: dict, base_lr: float, iters_per_epoch: int,
                      by_epoch: bool = True, max_iters: int = 0):
    """Build from an mmcv-style lr_config dict ('step' and 'fixed')."""
    lr_config = dict(lr_config or {})
    policy = lr_config.get('policy', 'step')
    warmup = lr_config.get('warmup', None)
    warmup_iters = lr_config.get('warmup_iters', 0)
    warmup_ratio = lr_config.get('warmup_ratio', 0.1)
    if policy == 'step':
        steps = lr_config.get('step', [])
        if isinstance(steps, (int, float)):
            steps = [steps]
        step_iters = [int(s * iters_per_epoch) if by_epoch else int(s)
                      for s in steps]
        return step_lr_schedule(base_lr, warmup, warmup_iters, warmup_ratio,
                                step_iters, lr_config.get('gamma', 0.1))
    if policy == 'fixed':
        return step_lr_schedule(base_lr, warmup, warmup_iters, warmup_ratio,
                                (), 1.0)
    raise NotImplementedError(f'lr policy {policy!r} is not ported yet')
