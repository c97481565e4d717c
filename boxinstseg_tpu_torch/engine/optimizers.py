"""Optimizer construction from mmcv-style optimizer configs, counterpart
of ``boxinstseg_tpu/engine/optimizers.py``.

The JAX package's SGD is optax ``add_decayed_weights -> trace ->
scale_by_learning_rate``: weight decay on EVERY parameter, heavy-ball
momentum without dampening. That is ``torch.optim.SGD`` with
``dampening=0``, provided every parameter has a gradient (see
``engine.train_state``)."""
from __future__ import annotations

from typing import Iterable

import torch


def build_optimizer(optimizer_cfg: dict,
                    params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop('type', 'SGD')
    if cfg.get('paramwise_cfg') or cfg.get('constructor'):
        raise NotImplementedError('paramwise optimizer options are not '
                                  'ported yet')
    if opt_type != 'SGD':
        raise NotImplementedError(f'optimizer {opt_type!r} is not ported '
                                  'yet')
    return torch.optim.SGD(params, lr=cfg['lr'],
                           momentum=cfg.get('momentum', 0.0),
                           dampening=0.0,
                           weight_decay=cfg.get('weight_decay', 0.0),
                           nesterov=cfg.get('nesterov', False))
