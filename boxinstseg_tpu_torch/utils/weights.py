"""JAX CondInst, Box2Mask, DiscoBox and BoxLevelset variables (ResNet or
Swin backbone) -> port ``state_dict``.

The inverse of ``boxinstseg_tpu.utils.checkpoint_convert.
convert_condinst_checkpoint``, ``convert_box2mask_head``,
``convert_discobox_head``, ``convert_discobox_mask_feat_head`` and
``convert_box_solov2_head``: it takes the
JAX package's ``params`` and
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

from ..models.backbones.swin import _rel_pos_index


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
    """Swin when the tree has ``stage0_block0``, else ResNet."""
    if 'stage0_block0' in params:
        _swin(sd, params)
        return
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


def _merge_perm(c: int) -> np.ndarray:
    """JAX PatchMerging input row j (block-major concat [x00 | x10 | x01 |
    x11], ``j = r*c + ch``) -> mmcv unfold channel ``ch*4 + (ky*2 + kx)``;
    the map of ``checkpoint_convert._merge_perm``, which the port inverts."""
    kmap = [0, 2, 1, 3]
    return np.asarray([ch * 4 + kmap[r] for r in range(4)
                       for ch in range(c)], np.int64)


def _unmerge(rows) -> np.ndarray:
    """Rows in the JAX concat order -> rows in mmcv's unfold order."""
    rows = np.asarray(rows)
    out = np.empty_like(rows)
    out[_merge_perm(rows.shape[0] // 4)] = rows
    return out


def _embed_table(table, window: int) -> torch.Tensor:
    """A JAX block's bias table -> the ``(2*window - 1)**2``-row table of
    the port. A JAX block whose window shrank to ``ws < window`` (a map
    smaller than the window) holds ``(2*ws - 1)**2`` rows; they go to the
    rows of the same offsets, and the rows no offset of that window reads
    are 0."""
    table = np.asarray(table, np.float32)
    span = int(round(np.sqrt(table.shape[0])))
    ws = (span + 1) // 2
    full = 2 * window - 1
    out = np.zeros((full, full, table.shape[1]), np.float32)
    lo = window - ws
    out[lo:lo + span, lo:lo + span] = table.reshape(span, span, -1)
    return torch.from_numpy(out.reshape(full * full, -1))


def _swin(sd, params):
    """JAX SwinTransformer tree -> mmdet Swin keys. The window is read from
    the largest bias table (stage 0's, whose map is never smaller than the
    window at a real input size)."""
    span = max(int(round(np.sqrt(np.asarray(node['attn'][
        'relative_position_bias_table']).shape[0])))
        for name, node in params.items() if name.startswith('stage'))
    window = (span + 1) // 2
    p = 'backbone'
    for name, node in params.items():
        if name == 'patch_embed':
            _emit_conv(sd, f'{p}.patch_embed.projection', node)
        elif name == 'patch_norm':
            _layer_norm(sd, f'{p}.patch_embed.norm', node)
        elif re.match(r'^out_norm\d+$', name):
            _layer_norm(sd, f'{p}.norm{name[8:]}', node)
        elif re.match(r'^merge_norm\d+$', name):
            sd[f'{p}.stages.{name[10:]}.downsample.norm.weight'] = \
                _t(_unmerge(node['scale']))
            sd[f'{p}.stages.{name[10:]}.downsample.norm.bias'] = \
                _t(_unmerge(node['bias']))
        elif re.match(r'^merge_reduction\d+$', name):
            sd[f'{p}.stages.{name[15:]}.downsample.reduction.weight'] = \
                _t(_unmerge(node['kernel']).T)
        else:
            m = re.match(r'^stage(\d+)_block(\d+)$', name)
            if not m:
                raise KeyError(f'unknown Swin backbone entry {name}')
            blk = f'{p}.stages.{m.group(1)}.blocks.{m.group(2)}'
            attn = node['attn']
            _layer_norm(sd, f'{blk}.norm1', node['norm1'])
            _layer_norm(sd, f'{blk}.norm2', node['norm2'])
            _linear(sd, f'{blk}.attn.w_msa.qkv', attn['qkv'])
            _linear(sd, f'{blk}.attn.w_msa.proj', attn['proj'])
            sd[f'{blk}.attn.w_msa.relative_position_bias_table'] = \
                _embed_table(attn['relative_position_bias_table'], window)
            sd[f'{blk}.attn.w_msa.relative_position_index'] = \
                torch.from_numpy(_rel_pos_index(window))
            _linear(sd, f'{blk}.ffn.layers.0.0', node['mlp_fc1'])
            _linear(sd, f'{blk}.ffn.layers.1', node['mlp_fc2'])


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
    """CondInst's box head, DiscoBox's SOLOv2 head (``kernel_conv_i``,
    ``cate_conv_i``, ``solo_*``) or BoxLevelset's, which also holds the
    unified feature (``feature_conv_i_j``, ``solo_mask``) and
    ``levelset_bottom``."""
    for name, node in params.items():
        m = re.match(r'^(cls|reg)_tower_(\d+)$', name) or \
            re.match(r'^(kernel|cate)_conv_(\d+)$', name)
        f = re.match(r'^feature_conv_(\d+)_(\d+)$', name)
        if m:
            _conv_module(sd, f'bbox_head.{m.group(1)}_convs.{m.group(2)}',
                         node, {})
        elif f:
            _conv_module(sd, f'bbox_head.feature_convs.{f.group(1)}.'
                         f'conv{f.group(2)}', node, {})
        elif name in ('conv_cls', 'conv_reg', 'conv_centerness',
                      'solo_cate', 'solo_kernel', 'solo_mask',
                      'levelset_bottom'):
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


def _mask_feat_head(sd, params):
    """DiscoBox's unified mask feature head: ``level_i_conv_j`` ->
    ``convs_all_levels.i.convj``, ``conv_pred`` -> ``conv_pred.0``."""
    for name, node in params.items():
        m = re.match(r'^level_(\d+)_conv_(\d+)$', name)
        if m:
            _conv_module(sd, f'mask_feat_head.convs_all_levels.{m.group(1)}'
                         f'.conv{m.group(2)}', node, {})
        elif name == 'conv_pred':
            _conv_module(sd, 'mask_feat_head.conv_pred.0', node, {})
        else:
            raise KeyError(f'unknown mask feature head entry {name}')


def _linear(sd, prefix, node):
    """flax Dense (kernel (in, out)) -> torch Linear (weight (out, in))."""
    sd[f'{prefix}.weight'] = _t(np.asarray(node['kernel']).T)
    if 'bias' in node:
        sd[f'{prefix}.bias'] = _t(node['bias'])


def _layer_norm(sd, prefix, node):
    sd[f'{prefix}.weight'] = _t(node['scale'])
    sd[f'{prefix}.bias'] = _t(node['bias'])


def _ffn(sd, prefix, node):
    _linear(sd, f'{prefix}.ffns.0.layers.0.0', node['fc1'])
    _linear(sd, f'{prefix}.ffns.0.layers.1', node['fc2'])


def _mha(sd, prefix, node):
    """q/k/v/out projections -> torch's packed in_proj and out_proj."""
    sd[f'{prefix}.attn.in_proj_weight'] = torch.cat(
        [_t(np.asarray(node[k]['kernel']).T)
         for k in ('q_proj', 'k_proj', 'v_proj')])
    sd[f'{prefix}.attn.in_proj_bias'] = torch.cat(
        [_t(node[k]['bias']) for k in ('q_proj', 'k_proj', 'v_proj')])
    _linear(sd, f'{prefix}.attn.out_proj', node['out_proj'])


def _pixel_decoder(sd, prefix, params):
    for name, node in params.items():
        m = re.match(r'^(input_conv|lateral_conv|output_conv)_(\d+)$', name)
        if m:
            _conv_module(sd, f'{prefix}.{m.group(1)}s.{m.group(2)}', node,
                         {})
            continue
        m = re.match(r'^encoder_layer_(\d+)$', name)
        if m:
            layer = f'{prefix}.encoder.layers.{m.group(1)}'
            for sub in ('sampling_offsets', 'attention_weights',
                        'value_proj', 'output_proj'):
                _linear(sd, f'{layer}.attentions.0.{sub}',
                        node['attn'][sub])
            _ffn(sd, layer, node['ffn'])
            for i in range(2):
                _layer_norm(sd, f'{layer}.norms.{i}', node[f'norm{i + 1}'])
        elif name == 'level_encoding':
            sd[f'{prefix}.level_encoding.weight'] = _t(node)
        elif name == 'mask_feature':
            _emit_conv(sd, f'{prefix}.mask_feature', node)
        else:
            raise KeyError(f'unknown pixel decoder entry {name}')


_MASK_EMBED = {'mask_embed_0': 0, 'mask_embed_1': 2, 'mask_embed_out': 4}


def _box2mask_head(sd, params):
    prefix = 'panoptic_head'
    for name, node in params.items():
        m = re.match(r'^decoder_layer_(\d+)$', name)
        if m:
            layer = f'{prefix}.transformer_decoder.layers.{m.group(1)}'
            _mha(sd, f'{layer}.attentions.0', node['cross_attn'])
            _mha(sd, f'{layer}.attentions.1', node['self_attn'])
            _ffn(sd, layer, node['ffn'])
            for i in range(3):
                _layer_norm(sd, f'{layer}.norms.{i}', node[f'norm{i + 1}'])
        elif name == 'pixel_decoder':
            _pixel_decoder(sd, f'{prefix}.pixel_decoder', node)
        elif name == 'post_norm':
            _layer_norm(sd, f'{prefix}.transformer_decoder.post_norm', node)
        elif name in ('query_embed', 'query_feat', 'level_embed'):
            sd[f'{prefix}.{name}.weight'] = _t(node)
        elif name == 'cls_embed':
            _linear(sd, f'{prefix}.cls_embed', node)
        elif name in _MASK_EMBED:
            _linear(sd, f'{prefix}.mask_embed.{_MASK_EMBED[name]}', node)
        elif name == 'levelset_bottom':
            _emit_conv(sd, f'{prefix}.levelset_bottom', node)
        else:
            raise KeyError(f'unknown Box2Mask head entry {name}')


def params_from_jax(params: Mapping, batch_stats: Mapping
                    ) -> Dict[str, torch.Tensor]:
    """JAX CondInst, Box2Mask, DiscoBox or BoxLevelset ``params`` /
    ``batch_stats`` ->
    port ``state_dict``.

    Each submodule tree (backbone_m, neck_m, bbox_head_m, mask_branch_m,
    mask_feat_head_m, panoptic_head_m) is converted when present, so a lone
    backbone or head converts too."""
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
    if 'mask_feat_head_m' in params:
        _mask_feat_head(sd, params['mask_feat_head_m'])
    if 'panoptic_head_m' in params:
        _box2mask_head(sd, params['panoptic_head_m'])
    return sd


def load_pretrained_backbone(backbone: torch.nn.Module, path: str) -> None:
    """A local torchvision-format ResNet ``.pth`` (a bare state_dict or one
    under ``state_dict``) into the port's ResNet, whose key names are
    torchvision's: the classifier ``fc.*`` is dropped, and so are the BN
    counters ``num_batches_tracked``, which the port's frozen BN lacks.
    Every backbone tensor must be in the file (the JAX package's
    ``load_torchvision_resnet``)."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    sd = sd.get('state_dict', sd)
    sd = {k: v for k, v in sd.items() if not k.startswith('fc.')
          and not k.endswith('num_batches_tracked')}
    missing, unexpected = backbone.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise KeyError(f'{path}: missing {missing[:5]}, unexpected '
                       f'{unexpected[:5]}')
