"""Training loop, counterpart of ``boxinstseg_tpu/apis/train.py``
``train_detector`` (reference: mmdet/apis/train.py:117-244).

``StaticBatcher`` + ``TrainLoader`` (the numpy data layer shared with the
JAX package; GT masks when the config asks for them, at stride 4, or 1 for
a fully supervised CondInst: ``mask_stride``), the LR schedule (scaled by
global batch / ``auto_scale_lr.base_batch_size`` when
``auto_scale_lr.enable`` is set), SGD or AdamW (with the LayerDecay
constructor where the config names it), the train step and the hooks of
``engine.hooks`` built from the config as the JAX package builds them: the
text log every ``log_config.interval`` steps, wandb, checkpoints by
``checkpoint_config`` (``iter_{n}.pth`` in the work dir, ``torch.save`` of
the model, the optimizer and ``_iter``), evaluation of a validation set by
``evaluation``, and ``custom_hooks`` (EMA, epoch info, YOLOX mode switch,
memory and profiler, the sync no-ops). A run resumes from
``resume_from`` (or, with ``auto_resume``, the newest checkpoint of the
work dir) at its ``_iter``.
DiscoBox (a ``SingleStageWSInsTSDetector``, such as ``DiscoBoxSOLOv2``)
takes the teacher-student step, with the object bank built on the device
from ``loss_corr.obj_bank`` and the schedule from ``ts_cfg``; its
checkpoint also keeps the teacher, the bank and ``avg_loss_ins``.

Data parallel across processes under a process group
(``parallel.dist.init_distributed``): the global batch is
``samples_per_gpu`` x world size, each rank loads its contiguous slice of
it and pads it as the whole batch would, the weights are broadcast from
rank 0 after init and after a resume, and the step averages the gradients
(``engine.train_state``); the losses' normalisers and the BN statistics are
the global batch's (``parallel.dist``). Rank 0 writes the log, the
checkpoints, the memory log and the profiler trace; the logged losses are
the mean over ranks.
"""
from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.batcher import StaticBatcher
from ..data.loader import TrainLoader
from ..engine import hooks as H
from ..engine.hooks import (CheckLossHook, CheckpointHook, EvalHook,
                            TextLoggerHook, latest_checkpoint,
                            num_class_check)
from ..engine.optimizers import build_optimizer
from ..engine.schedules import build_lr_schedule
from ..engine.train_state import TSTrainStep, make_train_step
from ..models.detectors.single_stage_ts import SingleStageWSInsTSDetector
from ..parallel import dist as pdist
from ..utils.env import set_tf32, tf32_from_cfg


def _train_resize_cfg(cfg):
    """The train pipeline's Resize step dict (walking dataset
    wrappers), or None."""
    train = (cfg.get('data') or {}).get('train')
    for _ in range(4):                       # Repeat/ClassBalanced nest
        if isinstance(train, dict) and 'pipeline' not in train \
                and 'dataset' in train:
            train = train['dataset']
        else:
            break
    if not isinstance(train, dict):
        return None
    for step in train.get('pipeline', []) or []:
        if isinstance(step, dict) and step.get('type') == 'Resize':
            return step
    return None


def default_canvases(cfg) -> list:
    """Canvas set for the config's train pipeline: up to 3 short-side
    buckets of a multiscale-'value' Resize, in both orientations (the JAX
    package's rule, so both packages pad batches alike)."""
    rs = _train_resize_cfg(cfg)
    base = [(800, 1344), (1344, 800)]
    if not rs:
        return base
    scales = rs.get('img_scale')
    if rs.get('ratio_range') is not None \
            or rs.get('multiscale_mode', 'range') != 'value' \
            or not isinstance(scales, (list, tuple)) or not scales \
            or not isinstance(scales[0], (list, tuple)):
        return base
    up32 = lambda v: -(-int(v) // 32) * 32   # noqa: E731
    shorts = sorted({min(s) for s in scales})
    long32 = up32(max(max(s) for s in scales))
    k = min(3, len(shorts))
    tops = sorted({shorts[-(-((i + 1) * len(shorts)) // k) - 1]
                   for i in range(k)})
    out = []
    for t in tops:
        out += [(up32(t), long32), (long32, up32(t))]
    return out


def batch_scale_choices(cfg):
    """Per-batch multiscale list for TrainLoader (None = per-image)."""
    rs = _train_resize_cfg(cfg)
    if not rs or rs.get('ratio_range') is not None:
        return None
    scales = rs.get('img_scale')
    if rs.get('multiscale_mode', 'range') == 'value' \
            and isinstance(scales, (list, tuple)) and len(scales) > 1 \
            and isinstance(scales[0], (list, tuple)):
        return [tuple(s) for s in scales]
    return None


def resolve_intervals(cfg: Config, iters_per_epoch: int) -> Dict[str, Any]:
    """mmcv ``by_epoch`` semantics as absolute iteration counts, the JAX
    package's ``resolve_intervals``:

    - ``lr_config.by_epoch`` (default True): step epochs -> iterations;
    - ``checkpoint_config.by_epoch`` (default True): interval in epochs
      unless set False (Box2Mask: 5000 iterations, by_epoch=False);
    - ``evaluation``'s interval is in epochs under an EpochBasedRunner and
      in iterations under an IterBasedRunner, whatever the evaluation dict
      says.
    """
    runner_cfg = cfg.get('runner', {'type': 'EpochBasedRunner',
                                    'max_epochs': 12})
    by_epoch_runner = runner_cfg.get('type') != 'IterBasedRunner'
    if by_epoch_runner:
        max_iters = runner_cfg.get('max_epochs', 12) * iters_per_epoch
    else:
        max_iters = runner_cfg['max_iters']

    lr_cfg = dict(cfg.get('lr_config') or {})
    lr_by_epoch = lr_cfg.get('by_epoch', True)

    ckpt_cfg = dict(cfg.get('checkpoint_config') or {})
    ckpt_iters = ckpt_cfg.get('interval', 1) * (
        iters_per_epoch if ckpt_cfg.get('by_epoch', True) else 1)

    eval_cfg = dict(cfg.get('evaluation') or {})
    eval_iters = eval_cfg.get('interval', 1) * (
        iters_per_epoch if by_epoch_runner else 1)
    dynamic = eval_cfg.get('dynamic_intervals')

    return dict(max_iters=max_iters, lr_by_epoch=lr_by_epoch,
                ckpt_interval_iters=int(ckpt_iters),
                ckpt_max_keep=ckpt_cfg.get('max_keep_ckpts', 3),
                ckpt_save_last=ckpt_cfg.get('save_last', True),
                eval_interval_iters=int(eval_iters),
                eval_dynamic_intervals=dynamic,
                eval_metrics=eval_cfg.get('metric', ('bbox', 'segm')))


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """numpy batch from ``StaticBatcher`` -> tensors on ``device``; the
    NHWC image canvas becomes NCHW. A host tensor in pinned memory is
    copied without blocking the host."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(
            np.ascontiguousarray(v))
        out[k] = t.to(device, non_blocking=t.is_pinned())
    out['image'] = out['image'].permute(0, 3, 1, 2).contiguous()
    return out


def build_object_bank(cfg, device):
    """The DiscoBox object bank of ``model.bbox_head.loss_corr.obj_bank``
    on ``device`` (reference ObjectQueues, discobox_head.py:132-227), or
    None when the config has no correspondence loss."""
    head = dict(cfg.model.get('bbox_head') or {})
    lc = head.get('loss_corr')
    if not lc:
        return None
    from ..ops.correspondence import create_object_bank
    ob = dict(lc.get('obj_bank', {}))
    return create_object_bank(
        int(head['num_classes']), int(ob.get('len_object_queues', 100)),
        (int(ob.get('feat_height', 7)), int(ob.get('feat_width', 7))),
        (int(ob.get('mask_height', 28)), int(ob.get('mask_width', 28))),
        int(cfg.model.get('neck', {}).get('out_channels', 256)),
        device=device)


def get_logger(log_file: Optional[str] = None) -> logging.Logger:
    """The package's logger at INFO (set on every call: a caller that
    changed the level and restored an unset one, as pytest's ``caplog``
    does, would leave INFO records dropped), writing to stderr and, when
    given, to ``log_file``."""
    logger = logging.getLogger('boxinstseg_tpu_torch')
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            '%(asctime)s - %(levelname)s - %(message)s'))
        logger.addHandler(handler)
    if log_file and not any(getattr(h, 'baseFilename', None)
                            == os.path.abspath(log_file)
                            for h in logger.handlers):
        logger.addHandler(logging.FileHandler(log_file))
    return logger


def apply_precision_policy(cfg) -> bool:
    """Whether the config asks for mixed precision, which the port runs as
    bf16 autocast (``engine.train_state.autocast_bf16``): the reference's
    ``fp16 = dict(loss_scale=...)`` key (the DiscoBox recipe; bf16 needs no
    loss scaling) or a native ``bf16 = True``, the JAX package's rule
    (its ``apply_precision_policy``)."""
    return bool(cfg.get('bf16', False)) or cfg.get('fp16') is not None


def _model_num_classes(model_cfg: dict):
    """First num_classes/num_things_classes found in the model cfg tree."""
    for key in ('num_classes', 'num_things_classes'):
        for sub in model_cfg.values():
            if isinstance(sub, dict) and key in sub:
                return sub[key]
    return None


@dataclass
class TrainResult:
    """What a run leaves: the step count (``_iter``), the logs of the
    logged steps (one every ``log_config.interval`` steps) as floats, with
    'time' and 'data_time' the mean seconds a step since the previous
    logged step, the path of the last checkpoint saved, and the metrics of
    each evaluation with the step after which it ran."""
    step: int
    history: List[Dict[str, float]] = field(default_factory=list)
    checkpoint: Optional[str] = None
    evaluations: List[Tuple[int, Dict[str, float]]] = field(
        default_factory=list)


class RunState:
    """The model, its optimizer and the train step of a run: what a
    checkpoint holds (``checkpoint``) and a resume restores
    (``restore``)."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, step_fn):
        self.model = model
        self.optimizer = optimizer
        self.step_fn = step_fn
        self.teacher_student = isinstance(step_fn, TSTrainStep)

    def checkpoint(self, step: int, meta=None) -> Dict[str, Any]:
        ckpt = {'state_dict': self.model.state_dict(),
                'optimizer': self.optimizer.state_dict(),
                '_iter': step, 'meta': dict(meta or {})}
        if self.teacher_student:
            ts = self.step_fn
            ckpt['teacher_state_dict'] = ts.teacher.state_dict()
            ckpt['avg_loss_ins'] = ts.avg_loss_ins
            if ts.bank is not None:
                ckpt['object_bank'] = ts.bank._asdict()
        return ckpt

    def restore(self, ckpt: Dict[str, Any]) -> int:
        """Load a ``checkpoint`` dict; returns its ``_iter``."""
        self.model.load_state_dict(ckpt['state_dict'])
        self.optimizer.load_state_dict(ckpt['optimizer'])
        if self.teacher_student:
            ts = self.step_fn
            ts.teacher.load_state_dict(ckpt['teacher_state_dict'])
            ts.avg_loss_ins = torch.as_tensor(ckpt['avg_loss_ins']).to(
                ts.avg_loss_ins.device)
            if ts.bank is not None:
                for name, saved in ckpt['object_bank'].items():
                    getattr(ts.bank, name).copy_(saved)
        return int(ckpt['_iter'])


def log_interval(cfg: Config) -> int:
    """``log_config.interval``; every step for a config without
    ``log_config``."""
    return dict(cfg.get('log_config') or {}).get('interval', 1)


def mask_stride(cfg: Config) -> int:
    """The stride of the batch's GT masks: 1 for a fully supervised
    CondInst (``mask_head.boxinst_enabled`` False), whose dice and semantic
    targets sample the full-resolution masks; 4 for every other model. The
    JAX package feeds stride 4 to both, on which its CondInst loss does not
    run (ROADMAP F8)."""
    mask_head_cfg = cfg.model.get('mask_head', {}) or {}
    supervised = cfg.model.get('type') == 'CondInst' and \
        not mask_head_cfg.get('boxinst_enabled', True)
    return 1 if supervised else 4


def build_train_loader(cfg: Config, dataset) -> TrainLoader:
    """The run's ``TrainLoader`` over ``dataset``: the global batch
    (``samples_per_gpu`` x world size), this rank's slice of it padded as
    the whole batch would be, the config's canvases, GT capacity and
    multiscale choice, GT masks at ``mask_stride(cfg)``,
    ``workers_per_gpu`` x 4 loading threads."""
    data_cfg = cfg.get('data', {})
    world = pdist.world_size()
    mask_head_cfg = cfg.model.get('mask_head', {}) or {}
    batcher = StaticBatcher(
        canvases=cfg.get('canvases', default_canvases(cfg)),
        max_gts=cfg.get('max_gts', 100),
        bottom_pixels_removed=mask_head_cfg.get('bottom_pixels_removed', 10),
        with_masks=bool(cfg.get('with_gt_masks',
                                not mask_head_cfg.get('boxinst_enabled',
                                                      True))),
        mask_stride=mask_stride(cfg), gt_buckets=cfg.get('gt_buckets'))
    return TrainLoader(dataset, data_cfg.get('samples_per_gpu', 2) * world,
                       batcher,
                       num_workers=data_cfg.get('workers_per_gpu', 2) * 4,
                       seed=cfg.get('seed', 0), process_id=pdist.rank(),
                       process_count=world,
                       batch_scales=batch_scale_choices(cfg),
                       extent_max=pdist.max_reducer())


def train_schedule(cfg: Config, global_batch: int, n_images: int):
    """(lr_fn, base LR, iters_per_epoch, resolved intervals) of a run over
    ``n_images`` at ``global_batch``. The base LR is ``optimizer.lr``, times
    global batch / ``auto_scale_lr.base_batch_size`` (16 by default) when
    ``auto_scale_lr.enable`` is set (the JAX package's rule)."""
    iters_per_epoch = max(n_images // global_batch, 1)
    iv = resolve_intervals(cfg, iters_per_epoch)
    base_lr = cfg.optimizer['lr']
    auto = dict(cfg.get('auto_scale_lr') or {})
    if auto.get('enable', False):
        base_lr = base_lr * global_batch / auto.get('base_batch_size', 16)
    lr_fn = build_lr_schedule(cfg.get('lr_config', {}), base_lr,
                              iters_per_epoch, by_epoch=iv['lr_by_epoch'],
                              max_iters=iv['max_iters'])
    return lr_fn, base_lr, iters_per_epoch, iv


LOG_HOOKS = ('TextLoggerHook', 'WandbLoggerHook', 'MMDetWandbHook')
RANK0_HOOKS = (TextLoggerHook, H.WandbLoggerHook, H.MemoryProfilerHook,
               H.ProfilerHook)


def custom_hook(h: dict, model, iv: Dict[str, Any], logger) -> H.Hook:
    """One ``custom_hooks`` entry with the JAX package's arguments and
    defaults (its ``apis/train.py`` ``build_hooks``); a type the JAX
    package does not build raises."""
    t = h.get('type')
    if t == 'MemoryProfilerHook':
        return H.MemoryProfilerHook(h.get('interval', 500), logger)
    if t == 'EMAHook':
        return H.EMAHook(h.get('momentum', 0.999), h.get('interval', 1))
    if t == 'ProfilerHook':
        return H.ProfilerHook(h.get('start', 50), h.get('stop', 55),
                              h.get('log_dir', './profile'), logger)
    if t == 'ExpMomentumEMAHook':
        return H.ExpMomentumEMAHook(h.get('momentum', 0.0002),
                                    h.get('total_iter', 2000),
                                    h.get('interval', 1))
    if t == 'LinearMomentumEMAHook':
        return H.LinearMomentumEMAHook(h.get('momentum', 0.0002),
                                       h.get('warm_up', 100),
                                       h.get('interval', 1))
    if t == 'SetEpochInfoHook':
        return H.SetEpochInfoHook(model)
    if t == 'YOLOXModeSwitchHook':
        return H.YOLOXModeSwitchHook(
            h.get('num_last_epochs', 15),
            h.get('skip_type_keys', ('Mosaic', 'RandomAffine', 'MixUp')),
            model, iv.get('train_dataset'), iv.get('max_epochs', 0), logger)
    if t in ('SyncNormHook', 'SyncRandomSizeHook'):
        return getattr(H, t)()
    raise NotImplementedError(f'custom hook {t} is not ported')


def build_hooks(cfg: Config, iv: Dict[str, Any], work_dir: str, logger,
                result: TrainResult, val_dataset=None, classes=None,
                model=None) -> list:
    """The hook list of the config, in the JAX package's order: the text
    log and the loss check every ``log_config.interval`` steps, wandb from
    ``log_config.hooks``, the checkpoints (written by rank 0; those of
    ``work_dir`` up to ``result.step``, where a resumed run starts, count
    as the run's own), the evaluation of ``val_dataset`` when there is one,
    then ``custom_hooks`` in their order (``custom_hook``; ``model`` for
    SetEpochInfoHook and YOLOXModeSwitchHook, which also reads
    ``iv['train_dataset']`` and ``iv['max_epochs']``). A config without
    ``log_config`` logs every step. A ``log_config.hooks`` entry other than
    ``TextLoggerHook``, ``WandbLoggerHook`` and ``MMDetWandbHook`` raises,
    as does a custom hook the JAX package does not build;
    ``NumClassCheckHook`` is run by ``train_detector`` up front. Ranks
    other than 0 drop the hooks that write or log (``RANK0_HOOKS``)."""
    log_cfg = dict(cfg.get('log_config') or {})
    for h in log_cfg.get('hooks') or []:
        if h.get('type') not in LOG_HOOKS:
            raise NotImplementedError(f'log hook {h.get("type")} is not '
                                      f'ported')
    interval = log_interval(cfg)
    meta = dict(seed=cfg.get('seed'),
                exp_name=os.path.basename(cfg.filename or ''),
                CLASSES=list(classes or cfg.get('classes') or []))
    global_batch = (cfg.get('data') or {}).get('samples_per_gpu', 2) \
        * pdist.world_size()
    hooks = [TextLoggerHook(interval, logger, iv['max_iters'],
                            result.history, global_batch),
             CheckLossHook(interval)]
    hooks += [H.WandbLoggerHook(h.get('interval', interval),
                                h.get('init_kwargs'), logger)
              for h in log_cfg.get('hooks') or []
              if h.get('type') != 'TextLoggerHook'
              and pdist.rank() == 0]
    hooks.append(CheckpointHook(work_dir, iv['ckpt_interval_iters'],
                                iv['ckpt_max_keep'], iv['ckpt_save_last'],
                                iv['max_iters'], logger, meta=meta,
                                start=result.step))
    if val_dataset is not None:
        hooks.append(EvalHook(val_dataset, cfg, iv['eval_interval_iters'],
                              iv['eval_metrics'], logger,
                              iv['eval_dynamic_intervals'],
                              result.evaluations))
    hooks += [custom_hook(h, model, iv, logger)
              for h in cfg.get('custom_hooks') or []
              if h.get('type') != 'NumClassCheckHook']
    if pdist.rank() != 0:
        hooks = [h for h in hooks if not isinstance(h, RANK0_HOOKS)]
    return hooks


def train_detector(model: torch.nn.Module, dataset, cfg: Config,
                   device='cuda', val_dataset=None,
                   resume_from: Optional[str] = None) -> TrainResult:
    """Train ``model`` on ``dataset`` as ``cfg`` says, on ``device`` (this
    rank's card under a process group); evaluate on ``val_dataset``, when
    given, by ``cfg.evaluation``. ``resume_from`` (or ``cfg.resume_from``;
    with ``cfg.auto_resume`` the newest checkpoint of the work dir)
    restores the model, the optimizer, the teacher-student state and
    ``_iter`` on every rank, and the run goes on from there, its loader
    from its first batch."""
    device = torch.device(device)
    work_dir = cfg.get('work_dir') or './work_dir'
    os.makedirs(work_dir, exist_ok=True)
    logger = get_logger(os.path.join(work_dir, 'train.log')
                        if pdist.rank() == 0 else None)
    set_tf32(tf32_from_cfg(cfg))
    bf16 = apply_precision_policy(cfg)
    if bf16:
        logger.info('mixed precision: bf16 activations, f32 params/losses')

    loader = build_train_loader(cfg, dataset)
    global_batch = loader.batch_size
    if pdist.is_distributed():
        logger.info(f'data parallel: rank {pdist.rank()} of '
                    f'{pdist.world_size()}, global batch {global_batch}, '
                    f'device {device}')

    lr_fn, base_lr, iters_per_epoch, iv = train_schedule(
        cfg, global_batch, len(dataset))
    max_iters = iv['max_iters']
    if base_lr != cfg.optimizer['lr']:
        logger.info(f'auto_scale_lr: base lr {cfg.optimizer["lr"]} -> '
                    f'{base_lr} at global batch {global_batch}')
    num_classes = _model_num_classes(cfg.model)
    if num_classes is not None and hasattr(dataset, 'CLASSES'):
        num_class_check(dataset, num_classes)

    model.to(device)
    pdist.broadcast_state(model)
    optimizer = build_optimizer(cfg.optimizer, model.named_parameters())
    grad_clip = (cfg.get('optimizer_config') or {}).get('grad_clip')
    if isinstance(model, SingleStageWSInsTSDetector):
        ts_cfg = dict(cfg.get('ts_cfg') or {})
        step_fn = TSTrainStep(
            model, optimizer, lr_fn, grad_clip,
            momentum=ts_cfg.get('momentum', 0.999),
            start_iter=ts_cfg.get('start_iter', 13000),
            ts_thresh=ts_cfg.get('ts_thresh', 0.3),
            corr_thresh=ts_cfg.get('corr_thresh', 0.2),
            bank=build_object_bank(cfg, device), bf16=bf16)
    else:
        step_fn = make_train_step(model, optimizer, lr_fn, grad_clip,
                                  bf16=bf16)
    state = RunState(model, optimizer, step_fn)

    resume_from = resume_from or cfg.get('resume_from')
    if not resume_from and cfg.get('auto_resume'):
        resume_from = latest_checkpoint(work_dir)
    start = 0
    if resume_from:
        start = state.restore(torch.load(resume_from, map_location='cpu',
                                         weights_only=False))
        pdist.broadcast_state(model)
        if state.teacher_student:
            pdist.broadcast_state(step_fn.teacher)
        logger.info(f'resumed from {resume_from} at iter {start}')

    result = TrainResult(step=start)
    interval = log_interval(cfg)
    iv['train_dataset'] = dataset
    iv['max_epochs'] = max(max_iters // iters_per_epoch, 1)
    hooks = build_hooks(cfg, iv, work_dir, logger, result,
                        val_dataset=val_dataset,
                        classes=getattr(dataset, 'CLASSES', None),
                        model=model)
    batches = iter(loader)
    try:
        for i in range(start, max_iters):
            for h in hooks:
                h.before_step(i)
            t0 = time.perf_counter()
            batch = batch_to_device(next(batches), device)
            data_time = time.perf_counter() - t0
            logs = step_fn(batch, i)
            logs['data_time'] = data_time
            if (i + 1) % interval == 0:
                logs = pdist.mean_over_ranks(logs)
            result.step = i + 1
            for h in hooks:
                h.after_step(i, state, logs)
            if (i + 1) % iters_per_epoch == 0:
                for h in hooks:
                    h.after_epoch((i + 1) // iters_per_epoch - 1, state)
    finally:
        batches.close()
    result.checkpoint = next(h.last for h in hooks
                             if isinstance(h, CheckpointHook))
    return result
