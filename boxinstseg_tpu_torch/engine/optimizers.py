"""Optimizer construction from mmcv-style optimizer configs, counterpart
of ``boxinstseg_tpu/engine/optimizers.py``.

- SGD: optax ``add_decayed_weights -> trace -> scale(lr)`` is
  ``torch.optim.SGD`` with ``dampening=0``, provided every parameter has a
  gradient (see ``engine.train_state``).
- AdamW: optax ``scale_by_adam -> add_decayed_weights(wd * decay_mult) ->
  scale(lr * lr_mult)`` is ``torch.optim.AdamW`` with a parameter group's
  ``lr = lr * lr_mult`` and ``weight_decay = wd * decay_mult`` (AdamW decays
  by ``lr * weight_decay * p``).

``paramwise_cfg`` follows the JAX package's ``paramwise_fns``: the longest
matching ``custom_keys`` entry sets ``lr_mult`` (and ``decay_mult``), and
``norm_decay_mult`` applies to the parameters that ``_is_norm_param``
calls norms. The rules read the port's mmdet-style parameter names and give
every parameter the multipliers of its JAX leaf. Each group keeps its
``lr_mult``, which the train step multiplies into the scheduled LR.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch


def is_norm_param(name: str, param: torch.Tensor) -> bool:
    """The JAX package's ``_is_norm_param`` test on the port's names: its
    ``/scale`` leaves are a norm's 1-D ``weight`` here (or a ``Scale``
    module's ``scale``), its ``/bn/``, ``/gn/`` are ``.bn.``, ``.gn.``."""
    lowered = name.lower()
    return (('norm' in lowered or '.bn.' in lowered or '.gn.' in lowered
             or lowered.endswith('.scale')
             or (lowered.endswith('.weight') and param.dim() == 1))
            and param.dim() <= 1)


def paramwise_multipliers(optimizer_cfg: dict):
    """(lr_mult(name), decay_mult(name, param)) of ``paramwise_cfg``."""
    if optimizer_cfg.get('constructor'):
        raise NotImplementedError(
            f'optimizer constructor {optimizer_cfg["constructor"]!r} is '
            f'not ported yet')
    pw = dict(optimizer_cfg.get('paramwise_cfg') or {})
    keys = sorted((pw.get('custom_keys') or {}).items(),
                  key=lambda kv: -len(kv[0]))
    norm_decay = pw.get('norm_decay_mult')

    def lr_mult(name: str) -> float:
        lowered = name.lower()
        for key, spec in keys:
            if key.lower() in lowered:
                return float(spec.get('lr_mult', 1.0))
        return 1.0

    def decay_mult(name: str, param: torch.Tensor) -> float:
        lowered = name.lower()
        for key, spec in keys:
            if key.lower() in lowered and 'decay_mult' in spec:
                return float(spec['decay_mult'])
        if norm_decay is not None and is_norm_param(name, param):
            return float(norm_decay)
        return 1.0

    return lr_mult, decay_mult


def param_groups(optimizer_cfg: dict,
                 named_params: Iterable[Tuple[str, torch.nn.Parameter]]
                 ) -> List[Dict]:
    """One group per (lr_mult, decay_mult) pair, in first-seen order, each
    with its ``lr``, ``weight_decay`` and ``lr_mult``."""
    lr = float(optimizer_cfg['lr'])
    wd = float(optimizer_cfg.get('weight_decay', 0.0))
    lr_mult, decay_mult = paramwise_multipliers(optimizer_cfg)
    groups: Dict[Tuple[float, float], Dict] = {}
    for name, p in named_params:
        key = (lr_mult(name), decay_mult(name, p))
        if key not in groups:
            groups[key] = dict(params=[], lr=lr * key[0],
                               weight_decay=wd * key[1], lr_mult=key[0])
        groups[key]['params'].append(p)
    return list(groups.values())


def build_optimizer(optimizer_cfg: dict,
                    named_params: Iterable[Tuple[str, torch.nn.Parameter]]
                    ) -> torch.optim.Optimizer:
    """``named_params``: ``model.named_parameters()``; ``paramwise_cfg``
    reads the names."""
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop('type', 'SGD')
    groups = param_groups(optimizer_cfg, named_params)
    if opt_type == 'SGD':
        return torch.optim.SGD(groups, lr=cfg['lr'],
                               momentum=cfg.get('momentum', 0.0),
                               dampening=0.0,
                               nesterov=cfg.get('nesterov', False))
    if opt_type == 'AdamW':
        return torch.optim.AdamW(groups, lr=cfg['lr'],
                                 betas=tuple(cfg.get('betas', (0.9, 0.999))),
                                 eps=cfg.get('eps', 1e-8))
    raise NotImplementedError(f'optimizer {opt_type!r} is not ported yet')
