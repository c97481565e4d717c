"""Training loop, counterpart of ``boxinstseg_tpu/apis/train.py``
``train_detector`` (reference: mmdet/apis/train.py:117-244).

One process: ``StaticBatcher`` + ``TrainLoader`` (the numpy data layer
shared with the JAX package; box bitmasks at stride 4 when the config asks
for GT masks), the LR schedule, SGD or AdamW, the train step, a text
log line per iteration and a final ``torch.save`` checkpoint that keeps
``_iter``. DiscoBox (a ``SingleStageWSInsTSDetector``, such as
``DiscoBoxSOLOv2``) takes the teacher-student step, with the object bank built on the device
from ``loss_corr.obj_bank`` and the schedule from ``ts_cfg``; its
checkpoint also keeps the teacher, the bank and ``avg_loss_ins``.
Distributed data parallelism and the evaluation hook are not ported yet.
"""
from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.batcher import StaticBatcher
from ..data.loader import TrainLoader
from ..engine.optimizers import build_optimizer
from ..engine.schedules import build_lr_schedule
from ..engine.train_state import TSTrainStep, make_train_step
from ..models.detectors.single_stage_ts import SingleStageWSInsTSDetector


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


def max_iters_of(cfg, iters_per_epoch: int) -> int:
    """mmcv runner semantics: epochs for EpochBasedRunner, iterations for
    IterBasedRunner."""
    runner = cfg.get('runner', {'type': 'EpochBasedRunner',
                                'max_epochs': 12})
    if runner.get('type') == 'IterBasedRunner':
        return int(runner['max_iters'])
    return int(runner.get('max_epochs', 12)) * iters_per_epoch


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """numpy batch from ``StaticBatcher`` -> tensors on ``device``; the
    NHWC image canvas becomes NCHW."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
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
    logger = logging.getLogger('boxinstseg_tpu_torch')
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            '%(asctime)s - %(levelname)s - %(message)s'))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
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


@dataclass
class TrainResult:
    """What a run leaves: the step count (``_iter``), the per-iteration
    logs as floats (with 'time' and 'data_time' in seconds) and the final
    checkpoint's path."""
    step: int
    history: List[Dict[str, float]] = field(default_factory=list)
    checkpoint: Optional[str] = None


def train_detector(model: torch.nn.Module, dataset, cfg: Config,
                   device='cuda') -> TrainResult:
    """Train ``model`` on ``dataset`` as ``cfg`` says, on ``device``."""
    device = torch.device(device)
    work_dir = cfg.get('work_dir') or './work_dir'
    os.makedirs(work_dir, exist_ok=True)
    logger = get_logger(os.path.join(work_dir, 'train.log'))
    bf16 = apply_precision_policy(cfg)
    if bf16:
        logger.info('mixed precision: bf16 activations, f32 params/losses')

    data_cfg = cfg.get('data', {})
    batch_size = data_cfg.get('samples_per_gpu', 2)
    mask_head_cfg = cfg.model.get('mask_head', {}) or {}
    batcher = StaticBatcher(
        canvases=cfg.get('canvases', default_canvases(cfg)),
        max_gts=cfg.get('max_gts', 100),
        bottom_pixels_removed=mask_head_cfg.get('bottom_pixels_removed', 10),
        with_masks=bool(cfg.get('with_gt_masks',
                                not mask_head_cfg.get('boxinst_enabled',
                                                      True))),
        mask_stride=4, gt_buckets=cfg.get('gt_buckets'))
    loader = TrainLoader(dataset, batch_size, batcher,
                         num_workers=data_cfg.get('workers_per_gpu', 2) * 4,
                         seed=cfg.get('seed', 0),
                         batch_scales=batch_scale_choices(cfg))

    iters_per_epoch = max(len(dataset) // batch_size, 1)
    max_iters = max_iters_of(cfg, iters_per_epoch)
    lr_by_epoch = dict(cfg.get('lr_config') or {}).get('by_epoch', True)
    lr_fn = build_lr_schedule(cfg.get('lr_config', {}), cfg.optimizer['lr'],
                              iters_per_epoch, by_epoch=lr_by_epoch,
                              max_iters=max_iters)

    model.to(device)
    optimizer = build_optimizer(cfg.optimizer, model.named_parameters())
    grad_clip = (cfg.get('optimizer_config') or {}).get('grad_clip')
    use_ts = isinstance(model, SingleStageWSInsTSDetector)
    if use_ts:
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

    result = TrainResult(step=0)
    batches = iter(loader)
    try:
        for i in range(max_iters):
            t0 = time.perf_counter()
            batch = batch_to_device(next(batches), device)
            t1 = time.perf_counter()
            logs = step_fn(batch, i)
            # the per-iteration log line reads every value: one sync a step
            logs = {k: float(v) for k, v in logs.items()}
            t2 = time.perf_counter()
            logs.update(time=t2 - t0, data_time=t1 - t0)
            result.history.append(logs)
            result.step = i + 1
            items = ', '.join(f'{k}: {v:.4f}' for k, v in logs.items()
                              if k not in ('lr', 'time', 'data_time'))
            logger.info(f'Iter [{i + 1}/{max_iters}] lr: {logs["lr"]:.3e}, '
                        f'{items}, time: {logs["time"]:.3f}, '
                        f'data_time: {logs["data_time"]:.3f}')
    finally:
        batches.close()

    path = os.path.join(work_dir, f'iter_{result.step}.pth')
    ckpt = {'state_dict': model.state_dict(),
            'optimizer': optimizer.state_dict(),
            '_iter': result.step,
            'meta': dict(seed=cfg.get('seed'),
                         exp_name=os.path.basename(cfg.filename or ''))}
    if use_ts:
        ckpt['teacher_state_dict'] = step_fn.teacher.state_dict()
        ckpt['avg_loss_ins'] = step_fn.avg_loss_ins
        if step_fn.bank is not None:
            ckpt['object_bank'] = step_fn.bank._asdict()
    torch.save(ckpt, path)
    logger.info(f'checkpoint saved at iter {result.step}: {path}')
    result.checkpoint = path
    return result
