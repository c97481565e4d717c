"""JAX CondInst (with its semantic head), Box2Mask, DiscoBox and
BoxLevelset variables -> port ``state_dict``: any backbone of the JAX
registry (ResNet, ResNeXt, ResNetV1d, ResNeSt, DetectoRS_ResNet, PVT v1 /
v2, Swin), any neck (FPN, PAFPN, ChannelMapper, FPN_CARAFE) and the
deformable tower convs.

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
    """A flax conv, or a deformable conv with its ``conv_offset``."""
    sd[f'{prefix}.weight'] = _conv(node['kernel'])
    if 'bias' in node:
        sd[f'{prefix}.bias'] = _t(node['bias'])
    if 'conv_offset' in node:
        _emit_conv(sd, f'{prefix}.conv_offset', node['conv_offset'])


def _emit_norm(sd, prefix, node, stats=None, tracked=False):
    sd[f'{prefix}.weight'] = _t(node['scale'])
    sd[f'{prefix}.bias'] = _t(node['bias'])
    if stats is not None:
        sd[f'{prefix}.running_mean'] = _t(stats['mean'])
        sd[f'{prefix}.running_var'] = _t(stats['var'])
        if tracked:
            sd[f'{prefix}.num_batches_tracked'] = torch.tensor(0)


def _emit_tree(sd, prefix, node, stats):
    """A block's subtree: convs (``kernel``), frozen BNs (``scale``, with
    their statistics), bare HWIO conv weights (the SAConv's ``weight`` and
    ``weight_diff``) and nested modules (the split-attention conv, the
    SAConv), by the JAX names."""
    for sub, leaf in node.items():
        if not isinstance(leaf, Mapping):
            sd[f'{prefix}.{sub}'] = _conv(leaf)
        elif 'kernel' in leaf:
            _emit_conv(sd, f'{prefix}.{sub}', leaf)
        elif 'scale' in leaf:
            _emit_norm(sd, f'{prefix}.{sub}', leaf, stats[sub])
        else:
            _emit_tree(sd, f'{prefix}.{sub}', leaf, stats.get(sub, {}))


def _backbone(sd, params, stats):
    """PVT when the tree has ``patch_embed0``, Swin when it has
    ``stage0_block0``, else a ResNet family member: ResNet, ResNeXt,
    ResNetV1d, ResNeSt or DetectoRS_ResNet. The deep stem's
    ``stem_conv{i}`` / ``stem_bn{i}`` go to ``stem.{3i}`` / ``stem.{3i+1}``.
    The JAX tree does not say whether a shortcut pools; a deep stem
    (ResNetV1d, ResNeSt) is taken to mean it does: the shortcut goes to
    ``downsample.{1,2}`` (its pool sits at index 0), else to
    ``downsample.{0,1}``. A ResNet whose ``deep_stem`` and ``avg_down``
    differ (no config sets them apart) fails the strict load."""
    if 'patch_embed0' in params:
        _pvt(sd, params)
        return
    if 'stage0_block0' in params:
        _swin(sd, params)
        return
    d0 = 1 if 'stem_conv0' in params else 0
    for name, node in params.items():
        st = stats.get(name, {})
        if name == 'conv1':
            _emit_conv(sd, 'backbone.conv1', node)
            continue
        if name == 'bn1':
            _emit_norm(sd, 'backbone.bn1', node, st)
            continue
        m = re.match(r'^stem_(conv|bn)(\d)$', name)
        if m:
            i = 3 * int(m.group(2)) + (m.group(1) == 'bn')
            if m.group(1) == 'conv':
                _emit_conv(sd, f'backbone.stem.{i}', node)
            else:
                _emit_norm(sd, f'backbone.stem.{i}', node, st)
            continue
        m = re.match(r'^layer(\d)_(\d+)$', name)
        if not m:
            raise KeyError(f'unknown backbone entry {name}')
        block = f'backbone.layer{m.group(1)}.{m.group(2)}'
        _emit_tree(sd, block, {k: v for k, v in node.items()
                               if not k.startswith('downsample_')}, st)
        if 'downsample_conv' in node:
            _emit_conv(sd, f'{block}.downsample.{d0}',
                       node['downsample_conv'])
            _emit_norm(sd, f'{block}.downsample.{d0 + 1}',
                       node['downsample_bn'], st['downsample_bn'])


def _pvt(sd, params):
    """JAX PyramidVisionTransformer(V2) tree -> mmdet PVT keys: stage i's
    patch embedding at ``layers.{i}.0``, its position embedding (v1) at
    ``layers.{i}.1.0`` and its blocks after it, its closing norm at
    ``layers.{i}.2``; q/k/v into ``in_proj``; the FFN's Dense layers as 1x1
    convs."""
    p = 'backbone.layers'
    for name, node in params.items():
        m = re.match(r'^(patch_embed|embed_norm|pos_embed|out_norm)(\d+)$',
                     name)
        if m:
            kind, i = m.group(1), m.group(2)
            if kind == 'patch_embed':
                _emit_conv(sd, f'{p}.{i}.0.projection', node)
            elif kind == 'embed_norm':
                _layer_norm(sd, f'{p}.{i}.0.norm', node)
            elif kind == 'pos_embed':
                sd[f'{p}.{i}.1.0.pos_embed'] = _t(node)
            else:
                _layer_norm(sd, f'{p}.{i}.2', node)
            continue
        m = re.match(r'^stage(\d+)_block(\d+)$', name)
        if not m:
            raise KeyError(f'unknown PVT backbone entry {name}')
        i = m.group(1)
        j = int(m.group(2)) + (f'pos_embed{i}' in params)
        blk = f'{p}.{i}.1.{j}'
        attn, ffn = node['attn'], node['ffn']
        _layer_norm(sd, f'{blk}.norm1', node['norm1'])
        _layer_norm(sd, f'{blk}.norm2', node['norm2'])
        sd[f'{blk}.attn.attn.in_proj_weight'] = torch.cat(
            [_t(np.asarray(attn[k]['kernel']).T) for k in 'qkv'])
        sd[f'{blk}.attn.attn.in_proj_bias'] = torch.cat(
            [_t(attn[k]['bias']) for k in 'qkv'])
        _linear(sd, f'{blk}.attn.attn.out_proj', attn['proj'])
        if 'sr' in attn:
            _emit_conv(sd, f'{blk}.attn.sr', attn['sr'])
            _layer_norm(sd, f'{blk}.attn.norm', attn['sr_norm'])
        for key, idx in (('fc1', 0), ('dwconv', 1),
                         ('fc2', 4 if 'dwconv' in ffn else 3)):
            if key not in ffn:
                continue
            leaf = dict(ffn[key])
            if key != 'dwconv':   # a Dense kernel (in, out) as a 1x1 conv
                leaf['kernel'] = np.asarray(leaf['kernel'])[None, None]
            _emit_conv(sd, f'{blk}.ffn.layers.{idx}', leaf)


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


def _carafe_encoder(node):
    """The JAX content encoder's output channels ``(sy*2 + sx) * k2 + k``
    -> mmcv's ``k * 4 + sy*2 + sx`` (FPN_CARAFE's scale 2)."""
    kernel, bias = np.asarray(node['kernel']), np.asarray(node['bias'])
    k2 = kernel.shape[-1] // 4
    order = np.asarray([q * k2 + k for k in range(k2) for q in range(4)])
    return dict(kernel=kernel[..., order], bias=bias[order])


def _neck(sd, params, stats):
    """FPN, PAFPN, ChannelMapper or FPN_CARAFE. The extra convs of FPN and
    PAFPN follow their laterals in ``fpn_convs``; ChannelMapper's are
    ``extra_convs``."""
    num_laterals = sum(1 for k in params if k.startswith('lateral_'))
    mapper = any(re.match(r'^conv_\d+$', k) for k in params)
    for name, node in params.items():
        kind, i = name.rsplit('_', 1)
        i = int(i)
        if kind == 'lateral':
            _emit_conv(sd, f'neck.lateral_convs.{i}.conv', node)
        elif kind == 'fpn_conv':
            _emit_conv(sd, f'neck.fpn_convs.{i}.conv', node)
        elif kind == 'extra_conv' and mapper:
            _conv_module(sd, f'neck.extra_convs.{i}', node,
                         stats.get(name, {}))
        elif kind == 'extra_conv':
            _emit_conv(sd, f'neck.fpn_convs.{num_laterals + i}.conv', node)
        elif kind in ('downsample_conv', 'pafpn_conv'):
            _emit_conv(sd, f'neck.{kind}s.{i}.conv', node)
        elif kind == 'conv':
            _conv_module(sd, f'neck.convs.{i}', node, stats.get(name, {}))
        elif kind == 'upsample':
            up = f'neck.upsample_modules.{i - 1}'
            _emit_conv(sd, f'{up}.channel_compressor',
                       node['channel_compressor'])
            _emit_conv(sd, f'{up}.content_encoder',
                       _carafe_encoder(node['content_encoder']))
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


def _segm_head(sd, params, stats):
    """CondInst's semantic head: ``segm_{i}`` -> ``segm_head.segm_branch.
    {i}`` (conv and BN with its statistics), ``segm_conv``."""
    for name, node in params.items():
        m = re.match(r'^segm_(\d+)$', name)
        if m:
            _conv_module(sd, f'segm_head.segm_branch.{m.group(1)}', node,
                         stats.get(name, {}))
        elif name == 'segm_conv':
            _emit_conv(sd, 'segm_head.segm_conv', node)
        else:
            raise KeyError(f'unknown semantic head entry {name}')


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


def _plain_pixel_decoder(sd, params):
    """The JAX ``PixelDecoder`` / ``TransformerEncoderPixelDecoder`` tree ->
    the port's (mmdet's) keys."""
    for name, node in params.items():
        m = re.match(r'^(lateral|output)_convs_(\d+)$', name)
        if m:
            _conv_module(sd, f'{m.group(1)}_convs.{m.group(2)}', node, {})
        elif name in ('last_feat_conv', 'encoder_out_proj'):
            _conv_module(sd, name, node, {})
        elif name in ('mask_feature', 'encoder_in_proj'):
            _emit_conv(sd, name, node)
        elif name == 'encoder':
            for lname, layer in node.items():
                prefix = f'encoder.layers.{lname.split("_")[1]}'
                _mha(sd, f'{prefix}.attentions.0', layer['attn'])
                _ffn(sd, prefix, layer['ffn'])
                for i in range(2):
                    _layer_norm(sd, f'{prefix}.norms.{i}',
                                layer[f'norm{i + 1}'])
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
    segm_head_m, mask_feat_head_m, panoptic_head_m) is converted when
    present, so a lone backbone or head converts too; so does the tree of
    a lone ``PixelDecoder`` or ``TransformerEncoderPixelDecoder`` (its
    own names at the top; DropBlock has no parameters)."""
    batch_stats = batch_stats or {}
    sd: Dict[str, torch.Tensor] = {}
    if 'last_feat_conv' in params or 'encoder_in_proj' in params:
        _plain_pixel_decoder(sd, params)
        return sd
    if 'backbone_m' in params:
        _backbone(sd, params['backbone_m'],
                  batch_stats.get('backbone_m', {}))
    if 'neck_m' in params:
        _neck(sd, params['neck_m'], batch_stats.get('neck_m', {}))
    if 'bbox_head_m' in params:
        _bbox_head(sd, params['bbox_head_m'])
    if 'mask_branch_m' in params:
        _mask_branch(sd, params['mask_branch_m'],
                     batch_stats.get('mask_branch_m', {}))
    if 'segm_head_m' in params:
        _segm_head(sd, params['segm_head_m'],
                   batch_stats.get('segm_head_m', {}))
    if 'mask_feat_head_m' in params:
        _mask_feat_head(sd, params['mask_feat_head_m'])
    if 'panoptic_head_m' in params:
        _box2mask_head(sd, params['panoptic_head_m'])
    return sd


def load_pretrained_backbone(backbone: torch.nn.Module, path: str) -> None:
    """A local ``.pth`` (a bare state_dict or one under ``state_dict``) into
    one of the port's backbones, by the port's key names: a torchvision
    ResNet / ResNeXt, an mmdet ResNet / ResNeXt / ResNetV1d (``stem.*``,
    ``downsample.{1,2}``), an mmdet PVT / PVTv2 or Swin, or a detector's
    checkpoint, whose ``backbone.*`` entries are taken. The classifier
    (``fc.*``, ``head.*``) is dropped, and so are the BN counters
    ``num_batches_tracked``, which the port's frozen BN lacks. Every
    backbone tensor must be in the file (the JAX package's
    ``load_torchvision_resnet``), at its shape: an mmdet ResNeSt or
    DetectoRS file raises, because the JAX modules that the port follows
    depart from mmdet's parameters there (README)."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    sd = sd.get('state_dict', sd)
    if any(k.startswith('backbone.') for k in sd):
        sd = {k[len('backbone.'):]: v for k, v in sd.items()
              if k.startswith('backbone.')}
    sd = {k: v for k, v in sd.items()
          if not k.startswith(('fc.', 'head.'))
          and not k.endswith('num_batches_tracked')}
    missing, unexpected = backbone.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise KeyError(f'{path}: missing {missing[:5]}, unexpected '
                       f'{unexpected[:5]}')
