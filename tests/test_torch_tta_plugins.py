"""The port's TTA merges (``ops/merge_augs.py``), plugins
(``models/plugins/{pixel_decoder,dropblock}.py``) and model utils
(``models/utils/{bricks,gaussian_target,point_sample}.py``) against the
JAX package's, on the CPU: the same seeded numpy inputs and the same
weights (the flax variables converted to the port's names), outputs and
input gradients within atol 1e-5 / rtol 1e-4, integer outputs exactly.

DropBlock's Bernoulli draw (flax ``make_rng``) cannot be reproduced
outside the JAX module, so the JAX module gets the test's seed map in
place of its draw, and what follows it is held to the port: the block
expansion and the rescale; also identity in eval and at drop_prob=0, and
the rate of the port's own draw.
"""
import importlib
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

import boxinstseg_tpu.models.plugins.dropblock as JD
import boxinstseg_tpu.models.utils.bricks as JB
import boxinstseg_tpu.models.utils.gaussian_target as JG
import boxinstseg_tpu.ops.merge_augs as JM
from boxinstseg_tpu.models.plugins.pixel_decoder import (
    PixelDecoder as JPixelDecoder,
    TransformerEncoderPixelDecoder as JTEPixelDecoder)

import boxinstseg_tpu_torch.models.utils.bricks as TB
import boxinstseg_tpu_torch.models.utils.gaussian_target as TG
import boxinstseg_tpu_torch.models.utils.point_sample as TP
import boxinstseg_tpu_torch.ops.merge_augs as TM
from boxinstseg_tpu_torch.models.plugins.dropblock import DropBlock
from boxinstseg_tpu_torch.models.plugins.pixel_decoder import (
    PixelDecoder, TransformerEncoderPixelDecoder)
from boxinstseg_tpu_torch.utils.weights import _conv, params_from_jax

# the package's __init__ exports the function point_sample under the
# module's name
JP = importlib.import_module('boxinstseg_tpu.models.utils.point_sample')
ATOL, RTOL = 1e-5, 1e-4


def close(got, want, exact=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact or want.dtype.kind in 'biu':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def t(x):
    return torch.from_numpy(np.array(x))


def nchw(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


def perturb(tree, rng):
    """Every leaf moved off its init (zero biases, unit scales), so that
    a swapped name shows."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.randn(*np.shape(a)) * 0.1
                                   ).astype(np.float32), tree)


# ------------------------------------------------------------------ TTA

METAS = [dict(img_shape=(60, 80), scale_factor=[1.0, 1.0, 1.0, 1.0],
              flip=False),
         dict(img_shape=(60, 80), scale_factor=[1.0, 1.0, 1.0, 1.0],
              flip=True, flip_direction='horizontal'),
         dict(img_shape=(90, 120), scale_factor=[1.5, 1.5, 1.5, 1.5],
              flip=True, flip_direction='diagonal')]


def _boxes(rng, n, w=80, h=60):
    xy = rng.rand(n, 2) * [w / 2, h / 2]
    wh = rng.rand(n, 2) * [w / 2, h / 2] + 1
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize('direction', ['horizontal', 'vertical',
                                       'diagonal'])
def test_bbox_flip_and_mapping_equal_jax(direction):
    rng = np.random.RandomState(0)
    b = np.concatenate([_boxes(rng, 7), _boxes(rng, 7)], 1)   # (7, 8)
    close(TM.bbox_flip(t(b), (60, 80), direction),
          JM.bbox_flip(jnp.asarray(b), (60, 80), direction))
    sf = [1.5, 2.0, 1.5, 2.0]
    for flip in (False, True):
        close(TM.bbox_mapping(t(b[:, :4]), (60, 80), sf, flip, direction),
              JM.bbox_mapping(jnp.asarray(b[:, :4]), (60, 80), sf, flip,
                              direction))
        close(TM.bbox_mapping_back(t(b[:, :4]), (60, 80), sf, flip,
                                   direction),
              JM.bbox_mapping_back(jnp.asarray(b[:, :4]), (60, 80), sf,
                                   flip, direction))


def test_merge_aug_proposals_bboxes_scores_equal_jax():
    rng = np.random.RandomState(1)
    props = [np.concatenate([_boxes(rng, 12), rng.rand(12, 1)], 1).astype(
        np.float32) for _ in METAS]
    for cfg in (dict(nms=dict(iou_threshold=0.5), max_per_img=10),
                dict(nms_thr=0.7)):
        close(TM.merge_aug_proposals([t(p) for p in props], METAS, cfg),
              JM.merge_aug_proposals([jnp.asarray(p) for p in props],
                                     METAS, cfg))
    bbs = [_boxes(rng, 9) for _ in METAS]
    scs = [rng.rand(9, 4).astype(np.float32) for _ in METAS]
    for a, b in zip(TM.merge_aug_bboxes([t(x) for x in bbs],
                                        [t(x) for x in scs], METAS),
                    JM.merge_aug_bboxes([jnp.asarray(x) for x in bbs],
                                        [jnp.asarray(x) for x in scs],
                                        METAS)):
        close(a, b)
    close(TM.merge_aug_bboxes([t(x) for x in bbs], None, METAS),
          JM.merge_aug_bboxes([jnp.asarray(x) for x in bbs], None, METAS))
    close(TM.merge_aug_scores([t(x) for x in scs]),
          JM.merge_aug_scores([jnp.asarray(x) for x in scs]))
    close(TM.merge_aug_scores(scs), JM.merge_aug_scores(scs))


@pytest.mark.parametrize('weights', [None, [0.3, 1.0, 2.0]])
def test_merge_aug_masks_equals_jax(weights):
    rng = np.random.RandomState(2)
    masks = [rng.randn(5, 2, 7, 9).astype(np.float32) for _ in METAS]
    metas = [dict(m) for m in METAS]
    metas[2]['flip_direction'] = 'vertical'
    close(TM.merge_aug_masks([t(m) for m in masks], [[m] for m in metas],
                             weights=weights),
          JM.merge_aug_masks([jnp.asarray(m) for m in masks],
                             [[m] for m in metas], weights=weights))


# -------------------------------------------------------- pixel decoders

CH = (8, 16, 32, 64)


def _feats(rng):
    return [rng.randn(2, 32 // 2 ** i + (i == 3), 24 // 2 ** i + 1, c
                      ).astype(np.float32) for i, c in enumerate(CH)]


@pytest.mark.parametrize('kind', ['PixelDecoder',
                                  'TransformerEncoderPixelDecoder'])
def test_pixel_decoders_equal_jax(kind):
    rng = np.random.RandomState(3)
    feats = _feats(rng)
    kw = dict(in_channels=CH, feat_channels=32, out_channels=16,
              norm_cfg=dict(type='GN', num_groups=4))
    if kind == 'PixelDecoder':
        jm, tm = JPixelDecoder(**kw), PixelDecoder(**kw)
    else:
        extra = dict(num_encoder_layers=2, num_heads=4,
                     feedforward_channels=48)
        jm = JTEPixelDecoder(**kw, **extra)
        tm = TransformerEncoderPixelDecoder(**kw, **extra)
    v = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 [jnp.asarray(f) for f in feats]), rng)
    sd = params_from_jax(v['params'], {})
    missing, unexpected = tm.load_state_dict(sd, strict=False)
    assert not unexpected and not [k for k in missing if 'positional' in k]
    tm.load_state_dict(sd, strict=True)
    (jmf, jmem), vjp = jax.vjp(jax.jit(lambda fs: jm.apply(v, fs)),
                               [jnp.asarray(f) for f in feats])
    proj = [rng.randn(*a.shape).astype(np.float32) for a in (jmf, jmem)]
    jg, = vjp(tuple(jnp.asarray(p) for p in proj))
    xs = [t(nchw(f)).requires_grad_() for f in feats]
    tmf, tmem = tm(xs)
    ((tmf * t(nchw(proj[0]))).sum()
     + (tmem * t(nchw(proj[1]))).sum()).backward()
    close(tmf, nchw(jmf))
    close(tmem, nchw(jmem))
    for x, g in zip(xs, jg):
        close(x.grad, nchw(g))


def test_params_from_jax_pixel_decoder_names_are_mmdets():
    tm = TransformerEncoderPixelDecoder(CH, 32, 16, num_encoder_layers=1,
                                        num_heads=4)
    keys = set(tm.state_dict())
    for k in ('encoder.layers.0.attentions.0.attn.in_proj_weight',
              'encoder.layers.0.ffns.0.layers.0.0.weight',
              'encoder.layers.0.norms.1.bias', 'encoder_in_proj.weight',
              'encoder_out_proj.conv.weight', 'encoder_out_proj.gn.weight',
              'lateral_convs.2.conv.weight', 'output_convs.0.gn.bias',
              'mask_feature.weight'):
        assert k in keys, k
    assert 'last_feat_conv.conv.weight' in PixelDecoder(CH, 32).state_dict()


# ------------------------------------------------------------- DropBlock

def test_dropblock_after_the_draw_equals_jax(monkeypatch):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 13, 11, 3).astype(np.float32)
    bs = 5
    seeds = (rng.rand(2, 13 - bs + 1, 11 - bs + 1, 3) < 0.1).astype(
        np.float32)
    monkeypatch.setattr(JD.jax.random, 'bernoulli',
                        lambda key, p, shape: jnp.asarray(seeds > 0))
    jm = JD.DropBlock(drop_prob=0.3, block_size=bs, warmup_iters=10)
    want = jm.apply({}, jnp.asarray(x), train=True,
                    iteration=jnp.asarray(4),
                    rngs={'dropout': jax.random.PRNGKey(0)})
    tm = DropBlock(drop_prob=0.3, block_size=bs, warmup_iters=10).train()
    got = tm(t(nchw(x)), iteration=4, seeds=t(nchw(seeds)))
    close(got, nchw(want))
    assert float(tm.gamma(13, 11, 4)) == pytest.approx(
        0.3 * 13 * 11 / (9 * 7 * 25) * 0.4, rel=1e-6)


def test_dropblock_identity_and_rate():
    x = torch.randn(2, 4, 40, 40, generator=torch.Generator().manual_seed(0))
    tm = DropBlock(drop_prob=0.2, block_size=3, warmup_iters=0)
    assert torch.equal(tm.eval()(x), x)
    zero = DropBlock(drop_prob=0.0, block_size=3).train()
    close(zero(x, generator=torch.Generator().manual_seed(1)), x.numpy())
    tm.train()
    gen = torch.Generator().manual_seed(2)
    gamma = float(tm.gamma(400, 400))
    u = torch.rand((8, 16, 398, 398), generator=gen)
    assert abs(float((u < gamma).float().mean()) / gamma - 1) < 0.02
    out = tm(x, generator=torch.Generator().manual_seed(3))
    dropped = float((out == 0).float().mean())
    assert 0.1 < dropped < 0.3                 # about drop_prob


# ---------------------------------------------------------------- bricks

def _flax_to_sd(params, stats):
    """A flax brick's variables -> the port brick's state_dict."""
    sd = {}

    def walk(node, st, path):
        for name, sub in node.items():
            key = {'dw_bn': 'depthwise_conv.bn'}.get(name, name)
            full = f'{path}.{key}' if path else key
            if isinstance(sub, dict):
                walk(sub, (st or {}).get(name, {}), full)
                continue
            a = np.asarray(sub)
            parent = full.rsplit('.', 1)[0] if '.' in full else ''
            pre = f'{parent}.' if parent else ''
            if name == 'kernel' and a.ndim == 4:
                target = 'depthwise_conv.conv.weight' \
                    if parent == 'depthwise_conv' else f'{pre}weight'
                sd[target] = _conv(a)
            elif name == 'kernel':
                sd[f'{pre}weight'] = torch.from_numpy(a.T.copy())
            elif name == 'scale':
                sd[f'{pre}weight'] = torch.from_numpy(a)
                sd[f'{pre}running_mean'] = torch.from_numpy(
                    np.array(st['mean'])) if st else None
                sd[f'{pre}running_var'] = torch.from_numpy(
                    np.array(st['var'])) if st else None
            else:
                sd[f'{pre}{name}'] = torch.from_numpy(a)
    walk(params, stats, '')
    return {k: v for k, v in sd.items() if v is not None}


BRICKS = {
    'SELayer': (lambda: JB.SELayer(16, 4), lambda: TB.SELayer(16, 4), 16,
                False),
    'DyReLU': (lambda: JB.DyReLU(16, 4), lambda: TB.DyReLU(16, 4), 16,
               False),
    'InvertedResidual': (
        lambda: JB.InvertedResidual(16, 16, 32, se_ratio=4),
        lambda: TB.InvertedResidual(16, 16, 32, se_ratio=4), 16, True),
    'InvertedResidual-s2': (
        lambda: JB.InvertedResidual(16, 24, 32, kernel_size=5, stride=2,
                                    with_expand_conv=False),
        lambda: TB.InvertedResidual(16, 24, 32, kernel_size=5, stride=2,
                                    with_expand_conv=False), 32, True),
    'NormedConv2d': (lambda: JB.NormedConv2d(8, 3),
                     lambda: TB.NormedConv2d(16, 8, 3), 16, False),
    'NormedConv2d-kernel': (
        lambda: JB.NormedConv2d(8, 1, norm_over_kernel=True),
        lambda: TB.NormedConv2d(16, 8, 1, norm_over_kernel=True), 16,
        False),
    'ConvUpsample': (
        lambda: JB.ConvUpsample(8, 3, 2, norm_cfg=dict(type='GN',
                                                       num_groups=4)),
        lambda: TB.ConvUpsample(16, 8, 3, 2, norm_cfg=dict(type='GN',
                                                           num_groups=4)),
        16, True),
    'SimplifiedBasicBlock': (
        lambda: JB.SimplifiedBasicBlock(8, 2, True),
        lambda: TB.SimplifiedBasicBlock(16, 8, 2, True), 16, True),
}


@pytest.mark.parametrize('name', sorted(BRICKS))
def test_bricks_equal_jax(name):
    jfn, tfn, cin, train_arg = BRICKS[name]
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, 10, cin).astype(np.float32)
    jm, tm = jfn(), tfn().train()
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = perturb(v['params'], rng)
    stats = v.get('batch_stats', {})
    sd = _flax_to_sd(params, stats)
    if name == 'ConvUpsample':
        sd = {re.sub(r'^conv(\d+)\.', r'conv.\1.', k): a
              for k, a in sd.items()}
    tm.load_state_dict(sd, strict=False)
    want_keys = {k for k in tm.state_dict() if 'num_batches' not in k}
    assert set(sd) == want_keys, set(sd) ^ want_keys
    variables = {'params': params, **({'batch_stats': stats}
                                      if stats else {})}

    def j_out(xx):
        if train_arg:
            return jm.apply(variables, xx, train=True,
                            mutable=['batch_stats'])[0]
        return jm.apply(variables, xx)
    jy, vjp = jax.vjp(jax.jit(j_out), jnp.asarray(x))
    proj = rng.randn(*jy.shape).astype(np.float32)
    jg, = vjp(jnp.asarray(proj))
    xt = t(nchw(x)).requires_grad_()
    ty = tm(xt)
    (ty * t(nchw(proj))).sum().backward()
    close(ty, nchw(jy))
    close(xt.grad, nchw(jg))


def test_normed_linear_equals_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(7, 12).astype(np.float32)
    jm = JB.NormedLinear(5, tempearture=10.0, power=2.0)
    v = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)),
                rng)
    tm = TB.NormedLinear(12, 5, tempearture=10.0, power=2.0)
    tm.load_state_dict({'weight': t(np.asarray(v['params']['kernel']).T),
                        'bias': t(v['params']['bias'])})
    close(tm(t(x)), jm.apply(v, jnp.asarray(x)))


def test_brick_functions_equal_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 11, 13, 3).astype(np.float32)
    for size in (1, (5, 4), (None, 6), 11):
        close(TB.adaptive_avg_pool2d(t(nchw(x)), size),
              nchw(JB.adaptive_avg_pool2d(jnp.asarray(x), size)))
    for v in (16, 30, 3.5, 90):
        assert TB.make_divisible(v, 8) == JB.make_divisible(v, 8)
    m = rng.rand(3, 7, 9).astype(np.float32)
    close(TB.interpolate_as(t(m), torch.zeros(4, 14, 17)),
          JB.interpolate_as(jnp.asarray(m), jnp.zeros((4, 14, 17))))
    close(TB.interpolate_as(t(nchw(x)), torch.zeros(1, 3, 20, 9)),
          nchw(JB.interpolate_as(jnp.asarray(x), jnp.zeros((1, 20, 9, 3)))))
    close(TB.scale_target(t(m), (5, 6)),
          JB.scale_target(jnp.asarray(m), (5, 6)))
    y = rng.randn(3, 4).astype(np.float32)
    close(TB.sigmoid_geometric_mean(t(y), t(y[::-1].copy())),
          JB.sigmoid_geometric_mean(jnp.asarray(y),
                                    jnp.asarray(y[::-1].copy())))


# -------------------------------------------------------- gaussian target

def test_gaussian_target_equals_jax():
    close(TG.gaussian2D(3, 1.2), JG.gaussian2D(3, 1.2))
    heat = np.zeros((20, 24), np.float32)
    jh, th = jnp.asarray(heat), t(heat)
    for (cx, cy), r in (((5, 6), 3), ((0, 19), 2), ((23, 0), 4),
                        ((12, 10), 0)):
        jh = JG.gen_gaussian_target(jh, (cx, cy), r)
        th = TG.gen_gaussian_target(th, (cx, cy), r)
    close(th, jh)
    for det, ov in (((37.0, 51.5), 0.7), ((3.0, 120.0), 0.3)):
        close(TG.gaussian_radius(det, ov), JG.gaussian_radius(det, ov))
        close(TG.gaussian_radius((t(np.float32(det[0])),
                                  t(np.float32(det[1]))), ov),
              JG.gaussian_radius((jnp.float32(det[0]),
                                  jnp.float32(det[1])), ov))
    rng = np.random.RandomState(8)
    hm = rng.randint(0, 5, (2, 3, 10, 12)).astype(np.float32) / 4
    close(TG.get_local_maximum(t(hm)), JG.get_local_maximum(jnp.asarray(hm)))
    for a, b in zip(TG.get_topk_from_heatmap(t(hm), 7),
                    JG.get_topk_from_heatmap(jnp.asarray(hm), 7)):
        close(a, b)
    feat = rng.randn(2, 5, 10, 12).astype(np.float32)
    ind = rng.randint(0, 120, (2, 6))
    mask = rng.rand(2, 6) > 0.3
    close(TG.transpose_and_gather_feat(t(feat), t(ind)),
          JG.transpose_and_gather_feat(jnp.asarray(feat), jnp.asarray(ind)))
    flat = feat.reshape(2, 5, -1).transpose(0, 2, 1).copy()
    close(TG.gather_feat(t(flat), t(ind), t(mask)),
          JG.gather_feat(jnp.asarray(flat), jnp.asarray(ind),
                         jnp.asarray(mask)))


# ---------------------------------------------------------- point sample

def test_point_sample_and_uncertain_points_equal_jax():
    rng = np.random.RandomState(9)
    m = rng.randn(3, 4, 9, 11).astype(np.float32)
    pts = (rng.rand(3, 50, 2) * 1.2 - 0.1).astype(np.float32)  # some off
    jy, vjp = jax.vjp(lambda a: JP.point_sample(a, jnp.asarray(pts)),
                      jnp.asarray(m))
    proj = rng.randn(*jy.shape).astype(np.float32)
    xt = t(m).requires_grad_()
    ty = TP.point_sample(xt, t(pts))
    (ty * t(proj)).sum().backward()
    close(ty, jy)
    close(xt.grad, vjp(jnp.asarray(proj))[0])
    labels = np.array([0, 3, 2], np.int32)
    close(TP.get_uncertainty(t(m), t(labels)),
          JP.get_uncertainty(jnp.asarray(m), jnp.asarray(labels)))
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    for n_pts, over, imp in ((12, 3.0, 0.75), (10, 2.0, 1.0)):
        s = int(n_pts * over)
        r = n_pts - int(imp * n_pts)
        noise = [t(np.asarray(jax.random.uniform(k1, (3, s, 2)))),
                 t(np.asarray(jax.random.uniform(k2, (3, r, 2))))]
        close(TP.get_uncertain_point_coords_with_randomness(
                  t(m), t(labels), n_pts, over, imp, noise=noise),
              JP.get_uncertain_point_coords_with_randomness(
                  jnp.asarray(m), jnp.asarray(labels), n_pts, over, imp,
                  key))
    out = TP.get_uncertain_point_coords_with_randomness(
        t(m), t(labels), 12, 3.0, 0.75,
        generator=torch.Generator().manual_seed(0))
    assert out.shape == (3, 12, 2) and bool(((out >= 0) & (out < 1)).all())
