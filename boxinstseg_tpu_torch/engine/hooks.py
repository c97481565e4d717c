"""Training-loop callbacks, counterpart of ``boxinstseg_tpu/engine/hooks.py``
(reference: the mmcv hook system and mmdet/core/hook).

The loop in ``apis.train.train_detector`` is explicit; each hook gets
``before_step(i)``, ``after_step(i, state, logs)`` and ``after_epoch(epoch,
state)`` calls, with ``i`` the 0-based step and ``state`` the run's
``apis.train.RunState`` (model, optimizer, train step). The interval
arithmetic is the JAX package's: a hook fires after step ``i`` when
``(i + 1) % interval == 0``.

- ``TextLoggerHook``: every ``interval`` steps, reads the step's logs (one
  device sync), appends them to the run's history with the window's mean
  step and data times, and logs a line;
- ``CheckLossHook``: aborts on a non-finite total loss, at the same steps;
- ``CheckpointHook``: ``iter_{n}.pth`` every ``interval`` steps and at
  ``max_iters`` with ``save_last``, the newest ``max_keep_ckpts`` of the
  run's own kept; written by rank 0, every rank waits for it;
- ``EvalHook``: ``apis.test.run_evaluation`` every ``interval`` steps,
  ``dynamic_intervals`` switching it once training passes their start, the
  metrics kept with their step;
- ``num_class_check``: the dataset's classes against the head's.

Under a process group (``parallel.dist``) ``apis.train.build_hooks`` gives
the text log to rank 0 only, and the logs a logged step passes are already
the mean over ranks, so every rank's loss check sees the same loss and all
stop together. The JAX package's EMA, YOLOX, wandb, memory and profiler
hooks are not ported.
"""
from __future__ import annotations

import math
import os
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..parallel import dist as pdist

CKPT_NAME = re.compile(r'^iter_(\d+)\.pth$')


def checkpoint_steps(work_dir: str) -> List[int]:
    """The steps of the ``iter_{n}.pth`` files in ``work_dir``, ascending."""
    if not os.path.isdir(work_dir):
        return []
    return sorted(int(m.group(1)) for m in map(CKPT_NAME.match,
                                                os.listdir(work_dir)) if m)


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """The newest ``iter_{n}.pth`` of ``work_dir``, or None."""
    steps = checkpoint_steps(work_dir)
    return os.path.join(work_dir, f'iter_{steps[-1]}.pth') if steps else None


class Hook:
    def before_step(self, i: int) -> None:
        pass

    def after_step(self, i: int, state, logs: Dict) -> None:
        pass

    def after_epoch(self, epoch: int, state) -> None:
        pass


class TextLoggerHook(Hook):
    """Every ``interval`` steps: the step's logs as floats (the one read of
    the losses, so the one device sync of those steps), with 'time' and
    'data_time' the window's mean seconds a step from the start of its
    first step to this read, appended to ``history`` and logged."""

    def __init__(self, interval: int, logger, max_iters: int,
                 history: List[Dict[str, float]]):
        self.interval = max(int(interval), 1)
        self.logger = logger
        self.max_iters = max_iters
        self.history = history
        self._t0 = None
        self._steps = 0
        self._data_time = 0.0

    def before_step(self, i):
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def after_step(self, i, state, logs):
        self._steps += 1
        self._data_time += logs['data_time']
        if (i + 1) % self.interval:
            return
        vals = {k: float(v) for k, v in logs.items()}
        vals['time'] = (time.perf_counter() - self._t0) / self._steps
        vals['data_time'] = self._data_time / self._steps
        self._t0, self._steps, self._data_time = None, 0, 0.0
        self.history.append(vals)
        items = ', '.join(f'{k}: {v:.4f}' for k, v in vals.items()
                          if k not in ('lr', 'time', 'data_time'))
        self.logger.info(f'Iter [{i + 1}/{self.max_iters}] lr: '
                         f'{vals["lr"]:.3e}, {items}, time: '
                         f'{vals["time"]:.3f}, data_time: '
                         f'{vals["data_time"]:.3f}')


class CheckLossHook(Hook):
    """Abort on a non-finite total loss (reference: CheckLossHook), at the
    logged steps."""

    def __init__(self, interval: int):
        self.interval = max(int(interval), 1)

    def after_step(self, i, state, logs):
        if (i + 1) % self.interval:
            return
        if not math.isfinite(float(logs['loss'])):
            raise FloatingPointError(
                f'non-finite loss at iter {i + 1}: '
                f'{ {k: float(v) for k, v in logs.items()} }')


class CheckpointHook(Hook):
    """``torch.save`` of ``state.checkpoint(n, meta)`` to
    ``work_dir/iter_{n}.pth`` by rank 0, then a barrier of every rank, after
    step n when n is a multiple of
    ``interval_iters``, or n is ``max_iters`` and ``save_last`` is set;
    then only the newest ``max_keep_ckpts`` of the run's files stay (all of
    them when it is 0 or less). The run's files are those it saves and,
    for a run resumed at step ``start``, those of ``work_dir`` up to that
    step; a newer file left by another run is never deleted. ``last``
    names the newest file saved."""

    def __init__(self, work_dir: str, interval_iters: int,
                 max_keep_ckpts: int = 3, save_last: bool = True,
                 max_iters: int = 0, logger=None, meta=None, start: int = 0):
        self.work_dir = work_dir
        self.interval = max(int(interval_iters), 1)
        self.max_keep = int(max_keep_ckpts)
        self.save_last = save_last
        self.max_iters = max_iters
        self.logger = logger
        self.meta = meta
        self.last: Optional[str] = None
        found = checkpoint_steps(work_dir)
        self.saved = [n for n in found if 0 < n <= start]
        later = [n for n in found if n > start]
        if later and logger is not None:
            logger.warning(f'{work_dir} holds checkpoints after iter {start} '
                           f'({later}), which this run will not prune')

    def after_step(self, i, state, logs):
        n = i + 1
        if n % self.interval and not (self.save_last
                                      and n == self.max_iters):
            return
        path = os.path.join(self.work_dir, f'iter_{n}.pth')
        self.last = path
        self.saved.append(n)
        drop = self.saved[:-self.max_keep] if self.max_keep > 0 else []
        self.saved = self.saved[len(drop):]
        if pdist.rank() == 0:
            torch.save(state.checkpoint(n, self.meta), path)
            for old in drop:
                os.remove(os.path.join(self.work_dir, f'iter_{old}.pth'))
            if self.logger is not None:
                self.logger.info(f'checkpoint saved at iter {n}: {path}')
        pdist.barrier()


class EvalHook(Hook):
    """``run_evaluation`` of ``state.model`` on ``dataset`` every
    ``interval_iters`` steps; ``dynamic_intervals`` [(start_iter,
    new_interval), ...] switch the interval once training passes
    start_iter (mmdet's dynamic-interval EvalHook); the metrics go to the
    log and, with the step after which they were taken, to
    ``evaluations``."""

    def __init__(self, dataset, cfg, interval_iters: int,
                 metrics=('bbox', 'segm'), logger=None,
                 dynamic_intervals=None,
                 evaluations: Optional[List[Tuple[int, Dict]]] = None):
        self.dataset = dataset
        self.cfg = cfg
        self.interval = max(int(interval_iters), 1)
        self.metrics = metrics
        self.logger = logger
        self.dynamic = sorted(dynamic_intervals or [])
        self.evaluations = [] if evaluations is None else evaluations

    def interval_at(self, i: int) -> int:
        interval = self.interval
        for start, new_interval in self.dynamic:
            if i + 1 >= start:
                interval = new_interval
        return max(int(interval), 1)

    def after_step(self, i, state, logs):
        if (i + 1) % self.interval_at(i):
            return
        from ..apis.test import run_evaluation
        metrics = run_evaluation(state.model, self.dataset, self.cfg,
                                 metrics=self.metrics)
        self.evaluations.append((i + 1, metrics))
        if self.logger is not None:
            self.logger.info(f'eval @ iter {i + 1}: {metrics}')


def num_class_check(dataset, model_num_classes: int) -> None:
    """reference: NumClassCheckHook - the dataset's CLASSES must match the
    head's num_classes."""
    n = len(dataset.CLASSES)
    if n != model_num_classes:
        raise ValueError(f'dataset has {n} classes but the head predicts '
                         f'{model_num_classes}')
