"""JAX CondInst variables -> port ``state_dict``.

The inverse of ``boxinstseg_tpu.utils.checkpoint_convert.
convert_condinst_checkpoint``: it takes the JAX package's ``params`` and
``batch_stats`` as nested dicts of numpy arrays and returns the port's
``state_dict`` (mmdet reference key names, OIHW conv weights), so both
packages can compute from the same weights. Only numpy and torch are
needed; the caller converts JAX arrays with ``np.asarray``.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _conv(kernel) -> torch.Tensor:
    """flax (H, W, I, O) -> torch (O, I, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(kernel), (3, 2, 0, 1))))


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _emit_conv(sd, prefix, node):
    sd[f'{prefix}.weight'] = _conv(node['kernel'])
    if 'bias' in node:
        sd[f'{prefix}.bias'] = _t(node['bias'])


def _emit_norm(sd, prefix, node, stats=None, tracked=False):
    sd[f'{prefix}.weight'] = _t(node['scale'])
    sd[f'{prefix}.bias'] = _t(node['bias'])
    if stats is not None:
        sd[f'{prefix}.running_mean'] = _t(stats['mean'])
        sd[f'{prefix}.running_var'] = _t(stats['var'])
        if tracked:
            sd[f'{prefix}.num_batches_tracked'] = torch.tensor(0)


def _backbone(sd, params, stats):
    for name, node in params.items():
        st = stats.get(name, {})
        if name in ('conv1', 'bn1'):
            if name == 'conv1':
                _emit_conv(sd, 'backbone.conv1', node)
            else:
                _emit_norm(sd, 'backbone.bn1', node, st)
            continue
        m = re.match(r'^layer(\d)_(\d+)$', name)
        if not m:
            raise KeyError(f'unknown backbone entry {name}')
        block = f'backbone.layer{m.group(1)}.{m.group(2)}'
        for sub, leaf in node.items():
            if sub == 'downsample_conv':
                _emit_conv(sd, f'{block}.downsample.0', leaf)
            elif sub == 'downsample_bn':
                _emit_norm(sd, f'{block}.downsample.1', leaf, st[sub])
            elif sub.startswith('conv'):
                _emit_conv(sd, f'{block}.{sub}', leaf)
            else:
                _emit_norm(sd, f'{block}.{sub}', leaf, st[sub])


def _neck(sd, params):
    num_laterals = sum(1 for k in params if k.startswith('lateral_'))
    for name, node in params.items():
        kind, i = name.rsplit('_', 1)
        i = int(i)
        if kind == 'lateral':
            _emit_conv(sd, f'neck.lateral_convs.{i}.conv', node)
        elif kind == 'fpn_conv':
            _emit_conv(sd, f'neck.fpn_convs.{i}.conv', node)
        elif kind == 'extra_conv':
            _emit_conv(sd, f'neck.fpn_convs.{num_laterals + i}.conv', node)
        else:
            raise KeyError(f'unknown neck entry {name}')


def _conv_module(sd, prefix, node, stats):
    _emit_conv(sd, f'{prefix}.conv', node['conv'])
    if 'gn' in node:
        _emit_norm(sd, f'{prefix}.gn', node['gn'])
    if 'bn' in node:
        _emit_norm(sd, f'{prefix}.bn', node['bn'], stats['bn'], tracked=True)


def _bbox_head(sd, params):
    for name, node in params.items():
        m = re.match(r'^(cls|reg)_tower_(\d+)$', name)
        if m:
            _conv_module(sd, f'bbox_head.{m.group(1)}_convs.{m.group(2)}',
                         node, {})
        elif name in ('conv_cls', 'conv_reg', 'conv_centerness'):
            _emit_conv(sd, f'bbox_head.{name}', node)
        elif name == 'param_conv':
            _emit_conv(sd, 'mask_head.param_conv', node)
        elif name.startswith('scale_'):
            sd[f'bbox_head.scales.{name[6:]}.scale'] = \
                _t(node['scale']).reshape(())
        else:
            raise KeyError(f'unknown bbox head entry {name}')


def _mask_branch(sd, params, stats):
    n_branch = sum(1 for k in params if k.startswith('branch_')
                   and k != 'branch_out')
    for name, node in params.items():
        if name == 'branch_out':
            _emit_conv(sd, f'mask_branch.mask_branch.{n_branch}', node)
            continue
        kind, i = name.rsplit('_', 1)
        prefix = {'refine': 'mask_branch.refines',
                  'branch': 'mask_branch.mask_branch'}[kind]
        _conv_module(sd, f'{prefix}.{i}', node, stats.get(name, {}))


def params_from_jax(params: Mapping, batch_stats: Mapping
                    ) -> Dict[str, torch.Tensor]:
    """JAX CondInst ``params`` / ``batch_stats`` -> port ``state_dict``.

    Each submodule tree (backbone_m, neck_m, bbox_head_m, mask_branch_m)
    is converted when present, so a lone backbone or head converts too."""
    batch_stats = batch_stats or {}
    sd: Dict[str, torch.Tensor] = {}
    if 'backbone_m' in params:
        _backbone(sd, params['backbone_m'],
                  batch_stats.get('backbone_m', {}))
    if 'neck_m' in params:
        _neck(sd, params['neck_m'])
    if 'bbox_head_m' in params:
        _bbox_head(sd, params['bbox_head_m'])
    if 'mask_branch_m' in params:
        _mask_branch(sd, params['mask_branch_m'],
                     batch_stats.get('mask_branch_m', {}))
    return sd
