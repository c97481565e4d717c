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
- ``EMAHook`` and its momentum-scheduled subclasses: an EMA of the
  parameters on their device;
- ``SetEpochInfoHook``, ``YOLOXModeSwitchHook``: the epoch into the model,
  the YOLOX mode switch into the dataset and the head;
- ``SyncNormHook``, ``SyncRandomSizeHook``: no-ops, kept so that configs
  naming them build;
- ``MemoryProfilerHook``, ``ProfilerHook``: each card's memory in use, a
  ``torch.profiler`` trace over a window of steps;
- ``WandbLoggerHook``: the logs to wandb, a no-op without it;
- ``num_class_check``: the dataset's classes against the head's.

Under a process group (``parallel.dist``) ``apis.train.build_hooks`` gives
the text log, wandb, the memory log and the profiler to rank 0 only, and
the logs a logged step passes are already the mean over ranks, so every
rank's loss check sees the same loss and all stop together. Every rank
keeps its EMA; the weights are the same on every rank, and so is the EMA.
"""
from __future__ import annotations

import contextlib
import logging
import math
import os
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..parallel import dist as pdist
from ..utils.profiling import device_memory_stats, trace

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
    first step to this read, appended to ``history`` and logged. The line
    is the JAX hook's layout, which ``tools/analysis_tools/analyze_logs.py``
    reads: ``Iter [i/N] lr: ..., time: T s/iter (global_batch / T img/s)``
    and then data_time and the logs."""

    def __init__(self, interval: int, logger, max_iters: int,
                 history: List[Dict[str, float]], global_batch: int = 1):
        self.interval = max(int(interval), 1)
        self.logger = logger
        self.max_iters = max_iters
        self.history = history
        self.global_batch = global_batch
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
        rate = self.global_batch / max(vals['time'], 1e-9)
        self.logger.info(f'Iter [{i + 1}/{self.max_iters}] lr: '
                         f'{vals["lr"]:.3e}, time: {vals["time"]:.3f}s/iter '
                         f'({rate:.1f} img/s) data_time: '
                         f'{vals["data_time"]:.3f}, {items}')


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


class EMAHook(Hook):
    """An exponential moving average of the model's parameters
    (``named_parameters()``; buffers are not averaged, as the JAX hook
    averages ``state.params`` only), every ``interval`` steps: a copy of
    the parameters at the first update, then ``ema = m * ema + (1 - m) *
    p``, in place on the parameters' device with ``torch._foreach_*``.

    ``momentum`` is the JAX package's KEEP-rate ``m`` (close to 1), not the
    reference's update rate: an mmdet config's ``momentum=0.0002`` means
    keep 0.9998 there and keep 0.0002 here. ``momentum_fun(i)``, set by the
    momentum-scheduled subclasses, gives the reference's update rate, applied
    as the keep-rate ``1 - momentum_fun(i)``. The average is neither used
    for evaluation nor written into checkpoints, as in the JAX package;
    ``ema_params`` holds it by parameter name (the reference's
    core/hook/ema.py BaseEMAHook)."""

    def __init__(self, momentum: float = 0.999, interval: int = 1,
                 momentum_fun: Optional[Callable[[int], float]] = None):
        self.momentum = momentum
        self.interval = max(int(interval), 1)
        self.momentum_fun = momentum_fun
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None

    def keep_rate(self, i: int) -> float:
        if self.momentum_fun is not None:
            return 1.0 - float(self.momentum_fun(i))
        return self.momentum

    @torch.no_grad()
    def after_step(self, i, state, logs):
        if (i + 1) % self.interval:
            return
        named = dict(state.model.named_parameters())
        if self.ema_params is None:
            self.ema_params = {k: p.detach().clone()
                               for k, p in named.items()}
            return
        m = self.keep_rate(i)
        ema = list(self.ema_params.values())
        torch._foreach_mul_(ema, m)
        torch._foreach_add_(ema, [named[k].detach()
                                  for k in self.ema_params], alpha=1.0 - m)


class ExpMomentumEMAHook(EMAHook):
    """EMA with an exponentially decaying update rate (reference ema.py:
    45-56): m_ref(t) = (1 - m0) * exp(-(1 + t) / total_iter) + m0."""

    def __init__(self, momentum: float = 0.0002, total_iter: int = 2000,
                 interval: int = 1):
        super().__init__(interval=interval, momentum_fun=lambda t: (
            1 - momentum) * math.exp(-(1 + t) / total_iter) + momentum)


class LinearMomentumEMAHook(EMAHook):
    """EMA with a linearly warming update rate (reference ema.py:59-71):
    m_ref(t) = min(m0 ** interval, (1 + t) / (warm_up + t))."""

    def __init__(self, momentum: float = 0.0002, warm_up: int = 100,
                 interval: int = 1):
        super().__init__(interval=interval, momentum_fun=lambda t: min(
            momentum ** interval, (1 + t) / (warm_up + t)))


class SetEpochInfoHook(Hook):
    """After an epoch, ``model.set_epoch(epoch + 1)`` where the model has
    one (reference core/hook/set_epoch_info_hook.py)."""

    def __init__(self, model=None):
        self.model = model

    def after_epoch(self, epoch, state):
        if self.model is not None and hasattr(self.model, 'set_epoch'):
            self.model.set_epoch(epoch + 1)


class SyncNormHook(Hook):
    """A no-op (reference core/hook/sync_norm_hook.py all-reduces the BN
    statistics over ranks before evaluation). The port's BN over the
    global batch (``models.layers.SyncBatchNorm``, whose moments are summed
    over ranks) leaves the same running statistics on every rank already,
    as the JAX package's global-batch program does."""

    def __init__(self, *args, **kwargs):
        pass


class SyncRandomSizeHook(Hook):
    """A no-op (reference core/hook/sync_random_size_hook.py broadcasts a
    random train size over ranks). The loader picks each batch's canvas
    over the global batch (``data.loader.TrainLoader``'s ``extent_max``),
    the same on every rank."""

    def __init__(self, *args, **kwargs):
        pass


class YOLOXModeSwitchHook(Hook):
    """For the last ``num_last_epochs``: the dataset's pipeline without
    ``skip_type_keys`` (``update_skip_type_keys``, as
    ``data.coco.MultiImageMixDataset``) and the head's ``use_l1`` set,
    where each exists (reference core/hook/yolox_mode_switch_hook.py)."""

    def __init__(self, num_last_epochs: int = 15,
                 skip_type_keys=('Mosaic', 'RandomAffine', 'MixUp'),
                 model=None, dataset=None, max_epochs: int = 0,
                 logger=None):
        self.num_last_epochs = num_last_epochs
        self.skip_type_keys = tuple(skip_type_keys)
        self.model = model
        self.dataset = dataset
        self.max_epochs = max_epochs
        self.logger = logger or logging.getLogger('boxinstseg_tpu_torch')

    def after_epoch(self, epoch, state):
        if (epoch + 2) != self.max_epochs - self.num_last_epochs + 1:
            return
        if hasattr(self.dataset, 'update_skip_type_keys'):
            self.dataset.update_skip_type_keys(self.skip_type_keys)
            self.logger.info('No mosaic and mixup aug now!')
        head = getattr(self.model, 'bbox_head', None)
        if hasattr(head, 'use_l1'):
            head.use_l1 = True
            self.logger.info('Add additional L1 loss now!')


class MemoryProfilerHook(Hook):
    """Every ``interval`` steps, each card's memory in use
    (``utils.profiling.device_memory_stats``) to the log; nothing without
    a card."""

    def __init__(self, interval: int = 500, logger=None):
        self.interval = max(int(interval), 1)
        self.logger = logger or logging.getLogger('boxinstseg_tpu_torch')

    def after_step(self, i, state, logs):
        if (i + 1) % self.interval:
            return
        for dev, stats in device_memory_stats().items():
            self.logger.info(f'{dev}: {stats["bytes_in_use"] / 2**30:.2f} '
                             f'GiB in use')


class ProfilerHook(Hook):
    """A ``torch.profiler`` trace (``utils.profiling.trace``) of the steps
    after step ``start`` up to step ``stop`` (1-based, the JAX hook's
    window), written to ``log_dir/trace.json`` after a sync of the card, so
    that the last step's kernels are in it; ``path`` names the file."""

    def __init__(self, start: int = 50, stop: int = 55,
                 log_dir: str = './profile', logger=None):
        self.start = start
        self.stop = stop
        self.log_dir = log_dir
        self.logger = logger or logging.getLogger('boxinstseg_tpu_torch')
        self.path: Optional[str] = None
        self._trace: Optional[contextlib.ExitStack] = None

    def after_step(self, i, state, logs):
        if (i + 1) == self.start and self._trace is None:
            self._trace = contextlib.ExitStack()
            self.path = self._trace.enter_context(trace(self.log_dir))
            self.logger.info(f'profiler trace started -> {self.log_dir}')
        elif (i + 1) == self.stop and self._trace is not None:
            self._trace.close()
            self._trace = None
            self.logger.info(f'profiler trace stopped: {self.path}')


class WandbLoggerHook(Hook):
    """Every ``interval`` steps, the step's logs to wandb (reference
    MMDetWandbHook); a no-op, with one warning, where ``wandb`` does not
    import."""

    def __init__(self, interval: int = 50,
                 init_kwargs: Optional[dict] = None, logger=None):
        self.interval = max(int(interval), 1)
        try:
            import wandb
        except ImportError:
            wandb = None
            (logger or logging.getLogger('boxinstseg_tpu_torch')).warning(
                'WandbLoggerHook: wandb does not import; nothing is logged '
                'to it')
        self.wandb = wandb
        if wandb is not None:
            wandb.init(**(init_kwargs or {}))

    def after_step(self, i, state, logs):
        if self.wandb is None or (i + 1) % self.interval:
            return
        self.wandb.log({k: float(v) for k, v in logs.items()}, step=i + 1)


def num_class_check(dataset, model_num_classes: int) -> None:
    """reference: NumClassCheckHook - the dataset's CLASSES must match the
    head's num_classes."""
    n = len(dataset.CLASSES)
    if n != model_num_classes:
        raise ValueError(f'dataset has {n} classes but the head predicts '
                         f'{model_num_classes}')
