"""Build the frozen copy of a detector from a configuration file's
``model`` dict, and the frozen batcher, schedule and parameter groups."""
from __future__ import annotations

import copy

import torch

from .frozen.registry import build_detector
from .frozen.models.backbones import resnet  # noqa: F401  (registers)
from .frozen.models.necks import fpn  # noqa: F401
from .frozen.models.dense_heads import (box2mask_head,  # noqa: F401
                                        condinst_head)
from .frozen.models.detectors import condinst, maskformer  # noqa: F401
from .frozen.models.plugins import msdeformattn_pixel_decoder  # noqa: F401
from .frozen.models.losses import (cross_entropy_loss,  # noqa: F401
                                   focal_loss, iou_loss,
                                   levelset_loss, projection)
from .frozen.data.batcher import StaticBatcher
from .frozen.engine.optimizers import param_groups
from .frozen.engine.schedules import build_lr_schedule


def build(cfg: dict, device) -> torch.nn.Module:
    """The detector of ``cfg['model']`` with its parameters on
    ``device`` (their values are overwritten by the caller)."""
    with torch.device(device):
        return build_detector(copy.deepcopy(cfg['model']))


def named_shapes(cfg: dict):
    """(name, shape) of every parameter of the configuration's detector,
    from a build on the meta device."""
    with torch.device('meta'):
        model = build_detector(copy.deepcopy(cfg['model']))
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def mask_stride(cfg: dict) -> int:
    mh = cfg['model'].get('mask_head') or {}
    supervised = cfg['model'].get('type') == 'CondInst' and \
        not mh.get('boxinst_enabled', True)
    return 1 if supervised else 4


def train_batcher(cfg: dict) -> StaticBatcher:
    mh = cfg['model'].get('mask_head') or {}
    return StaticBatcher(
        canvases=cfg['canvases'], max_gts=cfg.get('max_gts', 100),
        bottom_pixels_removed=mh.get('bottom_pixels_removed', 10),
        with_masks=bool(cfg.get('with_gt_masks',
                                not mh.get('boxinst_enabled', True))),
        mask_stride=mask_stride(cfg), gt_buckets=cfg.get('gt_buckets'))


def test_canvases(cfg: dict):
    """The configuration's canvases, then those of its test pipeline's
    scale (keep-ratio to ``MultiScaleFlipAug``'s scale, padded by ``Pad``'s
    divisor, both orientations)."""
    canvases = [tuple(c) for c in cfg['canvases']]
    for t in cfg.get('test_pipeline') or []:
        if t.get('type') != 'MultiScaleFlipAug':
            continue
        scales = t['img_scale']
        scales = [scales] if isinstance(scales[0], int) else scales
        div = next((u.get('size_divisor') for u in t.get('transforms', [])
                    if u.get('type') == 'Pad'), None) or 1
        up = lambda v: -(-int(v) // div) * div          # noqa: E731
        short = up(max(min(s) for s in scales))
        long = up(max(max(s) for s in scales))
        canvases += [c for c in [(short, long), (long, short)]
                     if c not in canvases]
    return canvases


def test_batcher(cfg: dict) -> StaticBatcher:
    return StaticBatcher(canvases=test_canvases(cfg), max_gts=1)


def lr_schedule(cfg: dict):
    """The scheduled LR by step at the configuration's ``schedule``
    (global batch and data set size), as mmcv's runner resolves it."""
    sched = cfg['schedule']
    iters_per_epoch = max(sched['dataset_images'] // sched['global_batch'],
                          1)
    runner = cfg.get('runner', {'type': 'EpochBasedRunner',
                                'max_epochs': 12})
    if runner.get('type') == 'IterBasedRunner':
        max_iters = runner['max_iters']
    else:
        max_iters = runner.get('max_epochs', 12) * iters_per_epoch
    lr_cfg = dict(cfg.get('lr_config') or {})
    return build_lr_schedule(lr_cfg, cfg['optimizer']['lr'],
                             iters_per_epoch,
                             by_epoch=lr_cfg.get('by_epoch', True),
                             max_iters=max_iters)


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device``, the NHWC image as NCHW."""
    import numpy as np
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    out['image'] = out['image'].permute(0, 3, 1, 2).contiguous()
    return out
