"""LR schedules with mmcv's LrUpdaterHook semantics, counterpart of
``boxinstseg_tpu/engine/schedules.py`` (reference: lr_config in
configs/_base_/schedules/schedule_1x.py - linear warmup + step decay; the
poly, cosine and YOLOX policies). Each schedule is a plain float function
of the 0-based step."""
from __future__ import annotations

import math
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


def _linear_warmup(base_lr: float, warmup: Optional[str],
                   warmup_iters: int, warmup_ratio: float,
                   after: Callable[[int], float]) -> Callable[[int], float]:
    """mmcv's linear warmup, base * (1 - (1 - i/warmup_iters) * (1 -
    warmup_ratio)), before ``warmup_iters``; ``after`` from there."""
    if warmup != 'linear' or warmup_iters <= 0:
        return after

    def schedule(count: int) -> float:
        if count < warmup_iters:
            k = (1.0 - count / warmup_iters) * (1.0 - warmup_ratio)
            return base_lr * (1.0 - k)
        return after(count)

    return schedule


def poly_lr_schedule(base_lr: float, max_iters: int, power: float = 0.9,
                     min_lr: float = 0.0, warmup: Optional[str] = 'linear',
                     warmup_iters: int = 0, warmup_ratio: float = 0.001
                     ) -> Callable[[int], float]:
    """(base - min) * (1 - i/max_iters)^power + min."""
    def poly(count: int) -> float:
        frac = min(max(count / max_iters, 0.0), 1.0)
        return (base_lr - min_lr) * (1.0 - frac) ** power + min_lr

    return _linear_warmup(base_lr, warmup, warmup_iters, warmup_ratio, poly)


def cosine_lr_schedule(base_lr: float, max_iters: int, min_lr: float = 0.0,
                       min_lr_ratio: Optional[float] = None,
                       warmup: Optional[str] = None, warmup_iters: int = 0,
                       warmup_ratio: float = 0.1) -> Callable[[int], float]:
    """mmcv CosineAnnealingLrUpdaterHook in its by_epoch=False form (by
    iteration whatever ``by_epoch`` says, as the JAX package):
    min + (base - min) * (1 + cos(pi * i/max_iters)) / 2, with ``min_lr``
    = base * ``min_lr_ratio`` when that is given."""
    if min_lr_ratio is not None:
        min_lr = base_lr * min_lr_ratio

    def cosine(count: int) -> float:
        t = min(max(count / max(max_iters, 1), 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(
            math.pi * t))

    return _linear_warmup(base_lr, warmup, warmup_iters, warmup_ratio,
                          cosine)


def yolox_lr_schedule(base_lr: float, max_iters: int,
                      min_lr_ratio: float = 0.05, warmup_iters: int = 0,
                      last_iters: int = 0) -> Callable[[int], float]:
    """mmdet YOLOXLrUpdaterHook: a quadratic warmup from LR 0, then cosine
    annealing to base * ``min_lr_ratio``, held over the last
    ``last_iters`` (reference core/hook/yolox_lrupdater_hook.py)."""
    min_lr = base_lr * min_lr_ratio
    span = max(max_iters - last_iters - warmup_iters, 1)

    def schedule(count: int) -> float:
        if count < warmup_iters:
            return base_lr * (count / max(warmup_iters, 1)) ** 2
        if count >= max_iters - last_iters:
            return min_lr
        t = min(max((count - warmup_iters) / span, 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1.0 + math.cos(
            math.pi * t))

    return schedule


def build_lr_schedule(lr_config: dict, base_lr: float, iters_per_epoch: int,
                      by_epoch: bool = True, max_iters: int = 0):
    """Build from an mmcv-style lr_config dict: the policies 'step',
    'fixed', 'poly', 'CosineAnnealing' (or 'cosine') and 'YOLOX' (or
    'yolox_cosine'); another raises."""
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
    if policy == 'poly':
        return poly_lr_schedule(base_lr, max_iters,
                                lr_config.get('power', 0.9),
                                lr_config.get('min_lr', 0.0),
                                warmup, warmup_iters, warmup_ratio)
    if policy == 'fixed':
        return step_lr_schedule(base_lr, warmup, warmup_iters, warmup_ratio,
                                (), 1.0)
    if policy in ('CosineAnnealing', 'cosine'):
        return cosine_lr_schedule(base_lr, max_iters,
                                  lr_config.get('min_lr', 0.0),
                                  lr_config.get('min_lr_ratio'),
                                  warmup, warmup_iters, warmup_ratio)
    if policy in ('YOLOX', 'yolox_cosine'):
        last_iters = int(lr_config.get('num_last_epochs', 15)
                         * iters_per_epoch)
        return yolox_lr_schedule(base_lr, max_iters,
                                 lr_config.get('min_lr_ratio', 0.05),
                                 warmup_iters, last_iters)
    raise ValueError(f'unsupported lr policy {policy}')
