"""Module-by-module parity of the PyTorch port against the JAX package.

Same seeded numpy inputs and the same weights (JAX variables converted with
``boxinstseg_tpu_torch.utils.weights.params_from_jax``) through each JAX
module and its port; NHWC (JAX) is transposed to NCHW (port) at the
comparison. Tolerance fp32 atol 1e-5 / rtol 1e-4 (convolution summation
order); integer outputs (labels, GT indices, sampled points, bitmasks)
must match exactly.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.core.targets import fcos as jfcos
from boxinstseg_tpu.models.backbones.resnet import ResNet as JResNet
from boxinstseg_tpu.models.dense_heads import condinst_head as jhead
from boxinstseg_tpu.models.losses import (CrossEntropyLoss as JCE,
                                          FocalLoss as JFocal,
                                          GIoULoss as JGIoU)
from boxinstseg_tpu.models.losses.projection import \
    compute_project_term as j_project
from boxinstseg_tpu.models.necks.fpn import FPN as JFPN
from boxinstseg_tpu.models.necks.fpn import _nearest_upsample_to
from boxinstseg_tpu.ops.points import concat_points_and_meta as j_points
from boxinstseg_tpu.ops.upsample import aligned_bilinear as j_bilinear

from boxinstseg_tpu_torch.core.targets import fcos as tfcos
from boxinstseg_tpu_torch.models.backbones.resnet import ResNet
from boxinstseg_tpu_torch.models.dense_heads import condinst_head as thead
from boxinstseg_tpu_torch.models.losses import (CrossEntropyLoss, FocalLoss,
                                                GIoULoss)
from boxinstseg_tpu_torch.models.losses.projection import \
    compute_project_term
from boxinstseg_tpu_torch.models.necks.fpn import FPN, nearest_upsample_to
from boxinstseg_tpu_torch.ops.points import concat_points_and_meta
from boxinstseg_tpu_torch.ops.upsample import aligned_bilinear
from boxinstseg_tpu_torch.utils.weights import params_from_jax

ATOL, RTOL = 1e-5, 1e-4
STRIDES = (8, 16, 32, 64, 128)


def close(got, want, atol=ATOL, rtol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def t(x):
    return torch.from_numpy(np.array(x))


def randomize(tree, rng):
    """Random norm statistics and affine terms (init values are 0/1 and
    would hide a mix-up); conv kernels keep their init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
        elif k in ('scale', 'var'):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k in ('bias', 'mean'):
            out[k] = (rng.randn(*np.shape(v)) * 0.1).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def jax_vars(module, seed, *args, method=None, **kw):
    v = module.init(jax.random.PRNGKey(seed), *args, method=method, **kw)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(seed)
    return {k: randomize(dict(x), rng) for k, x in v.items()}


def load(module, variables, prefix, sub):
    """Load converted JAX variables of submodule ``sub`` (e.g.
    'backbone_m') into a standalone port module."""
    sd = params_from_jax({sub: variables['params']},
                         {sub: variables.get('batch_stats', {})})
    own = {k[len(prefix) + 1:]: v for k, v in sd.items()
           if k.startswith(prefix + '.')}
    module.load_state_dict(own, strict=True)
    return sd


def level_feats(rng, b, c, hw0=(16, 20)):
    h, w = hw0
    out = []
    for _ in STRIDES:
        out.append(rng.randn(b, h, w, c).astype(np.float32))
        h, w = -(-h // 2), -(-w // 2)
    return out


# ---------------------------------------------------------------- backbone

@pytest.mark.parametrize('depth', [18, 50])
def test_resnet_features(depth):
    x = np.random.RandomState(depth).rand(2, 64, 96, 3).astype(
        np.float32) * 4 - 2
    jm = JResNet(depth=depth, frozen_stages=1)
    v = jax_vars(jm, 0, jnp.asarray(x))
    want = jm.apply(v, jnp.asarray(x))
    tm = ResNet(depth=depth, frozen_stages=1)
    load(tm, v, 'backbone', 'backbone_m')
    got = tm(t(nchw(x)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        close(g, nchw(w))


@pytest.mark.parametrize('layout', [
    dict(start_level=1, add_extra_convs='on_output',
         relu_before_extra_convs=True),               # BoxInst P3-P7
    dict(start_level=0, add_extra_convs=False)])      # SOLO-family P2-P6
def test_fpn(layout):
    rng = np.random.RandomState(0)
    chans = (16, 32, 64, 128)
    xs = [rng.randn(2, 16 // 2 ** i, 24 // 2 ** i, c).astype(np.float32)
          for i, c in enumerate(chans)]
    kw = dict(in_channels=chans, out_channels=32, num_outs=5, **layout)
    jm = JFPN(**kw)
    v = jax_vars(jm, 1, [jnp.asarray(a) for a in xs])
    want = jm.apply(v, [jnp.asarray(a) for a in xs])
    tm = FPN(**kw)
    load(tm, v, 'neck', 'neck_m')
    got = tm([t(nchw(a)) for a in xs])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        close(g, nchw(w))


def test_fpn_nearest_upsample_odd_sizes():
    x = np.random.RandomState(2).randn(1, 5, 7, 3).astype(np.float32)
    want = _nearest_upsample_to(jnp.asarray(x), (9, 13))
    close(nearest_upsample_to(t(nchw(x)), (9, 13)), nchw(want), 0, 0)


# ---------------------------------------------------------------- box head

HEAD_KW = dict(num_classes=4, in_channels=32, feat_channels=32,
               stacked_convs=2, norm_cfg=dict(type='GN', num_groups=4))


def _gt(rng, b=2, g=5, h=128, w=160, classes=4):
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(rng.randint(1, g + 1)):
            x1, y1 = rng.randint(0, w - 40), rng.randint(0, h - 40)
            boxes[i, j] = (x1, y1, x1 + rng.randint(12, 40),
                           y1 + rng.randint(12, 40))
            labels[i, j] = rng.randint(0, classes)
            valid[i, j] = True
    return boxes, labels, valid


@pytest.fixture(scope='module')
def box_head_pair():
    rng = np.random.RandomState(3)
    feats = level_feats(rng, 2, 32)
    jm = jhead.CondInstBoxHead(num_gen_params=169, **HEAD_KW)
    v = jax_vars(jm, 3, [jnp.asarray(f) for f in feats], train=True)
    tm = thead.CondInstBoxHead(**HEAD_KW).train()
    sd = load(tm, v, 'bbox_head', 'bbox_head_m')
    mask_head = thead.CondInstMaskHead(in_channels=8, bbox_head_channels=32)
    mask_head.param_conv.load_state_dict(
        {k.split('.')[-1]: x for k, x in sd.items()
         if k.startswith('mask_head.param_conv.')})
    return jm, v, tm, mask_head, feats


def test_box_head_outputs(box_head_pair):
    jm, v, tm, mask_head, feats = box_head_pair
    want = jm.apply(v, [jnp.asarray(f) for f in feats], train=True)
    got = tm([t(nchw(f)) for f in feats])
    got['param'] = [mask_head.param_conv(f) for f in got['reg_feat']]
    for key in ('cls', 'bbox', 'ctr', 'param'):
        for g, w in zip(got[key], want[key]):
            close(g, nchw(w))


def test_box_head_loss_and_targets(box_head_pair):
    jm, v, tm, mask_head, feats = box_head_pair
    boxes, labels, valid = _gt(np.random.RandomState(4))
    outs = jm.apply(v, [jnp.asarray(f) for f in feats], train=True)
    want, wt, _ = jm.apply(v, outs, jnp.asarray(boxes), jnp.asarray(labels),
                           jnp.asarray(valid), method=jm.loss)
    touts = {k: [t(nchw(x)) for x in outs[k]] for k in ('cls', 'bbox',
                                                         'ctr')}
    got, gt_, _ = tm.loss(touts, t(boxes), t(labels), t(valid))
    for k in want:
        close(got[k], want[k])
    np.testing.assert_array_equal(gt_.labels.numpy(), np.asarray(wt.labels))
    np.testing.assert_array_equal(gt_.gt_inds.numpy(), np.asarray(wt.gt_inds))
    close(gt_.bbox_targets, wt.bbox_targets)
    close(gt_.centerness, wt.centerness)


def test_fcos_targets_and_sampling_match_exactly():
    rng = np.random.RandomState(5)
    sizes = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    rr = jhead.DEFAULT_REGRESS_RANGES
    jp = j_points(sizes, STRIDES, regress_ranges=rr)
    tp = concat_points_and_meta(sizes, STRIDES, regress_ranges=rr)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    boxes, labels, valid = _gt(rng, b=3, g=6)
    jt = jfcos.fcos_targets(jp['points'], jp['strides'],
                            jp['regress_ranges'], jnp.asarray(boxes),
                            jnp.asarray(labels), jnp.asarray(valid), 4)
    tt = tfcos.fcos_targets(tp['points'], tp['strides'],
                            tp['regress_ranges'], t(boxes), t(labels),
                            t(valid), 4)
    np.testing.assert_array_equal(tt.labels.numpy(), np.asarray(jt.labels))
    np.testing.assert_array_equal(tt.gt_inds.numpy(), np.asarray(jt.gt_inds))
    close(tt.bbox_targets, jt.bbox_targets)
    close(tt.centerness, jt.centerness)
    # scores on a coarse grid: many exact ties exercise the stable sorts
    scores = np.round(rng.rand(3, tp['points'].shape[0]), 1).astype(
        np.float32)
    for cap in (4, 8, 64):
        want = jfcos.sample_positives_per_gt(
            jnp.asarray(scores), jt.gt_inds, jnp.asarray(valid), cap)
        got = tfcos.sample_positives_per_gt(t(scores), tt.gt_inds,
                                            t(valid), cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------------- losses

def test_focal_giou_ce_losses():
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 50, 4).astype(np.float32) * 2
    labels = rng.randint(0, 5, (2, 50)).astype(np.int32)   # 4 = background
    w = rng.rand(2, 50).astype(np.float32)
    a = rng.rand(2, 50, 4).astype(np.float32) * 50
    pred = np.concatenate([a[..., :2], a[..., :2] + a[..., 2:] + 1], -1)
    b = rng.rand(2, 50, 4).astype(np.float32) * 50
    tgt = np.concatenate([b[..., :2], b[..., :2] + b[..., 2:] + 1], -1)
    ctr_t = rng.rand(2, 50).astype(np.float32)

    want = jax.value_and_grad(lambda x: JFocal()(
        x, jnp.asarray(labels), avg_factor=jnp.float32(7.0)))(
        jnp.asarray(logits))
    x = t(logits).requires_grad_(True)
    got = FocalLoss()(x, t(labels).long(), avg_factor=torch.tensor(7.0))
    got.backward()
    close(got, want[0])
    close(x.grad, want[1])

    close(GIoULoss()(t(pred), t(tgt), weight=t(w), avg_factor=3.0),
          JGIoU()(jnp.asarray(pred), jnp.asarray(tgt), weight=jnp.asarray(w),
                  avg_factor=3.0))
    ce = dict(use_sigmoid=True, loss_weight=1.0)
    close(CrossEntropyLoss(**ce)(t(logits[..., 0]), t(ctr_t), weight=t(w),
                                 avg_factor=5.0),
          JCE(**ce)(jnp.asarray(logits[..., 0]), jnp.asarray(ctr_t),
                    weight=jnp.asarray(w), avg_factor=5.0))


# ------------------------------------------------------------ mask branch

def test_mask_branch_train_mode_and_bn_stats():
    rng = np.random.RandomState(7)
    feats = level_feats(rng, 2, 32)[:3]
    kw = dict(in_channels=32, branch_convs=2, branch_channels=16,
              branch_out_channels=8)
    jm = jhead.CondInstMaskBranch(**kw)
    v = jax_vars(jm, 7, [jnp.asarray(f) for f in feats], train=True)
    want, new_state = jm.apply(v, [jnp.asarray(f) for f in feats],
                               train=True, mutable=['batch_stats'])
    tm = thead.CondInstMaskBranch(**kw).train()
    load(tm, v, 'mask_branch', 'mask_branch_m')
    got = tm([t(nchw(f)) for f in feats])
    close(got, nchw(want))
    new_sd = params_from_jax(
        {'mask_branch_m': v['params']},
        {'mask_branch_m': jax.tree_util.tree_map(
            np.asarray, dict(new_state['batch_stats']))})
    for k, x in tm.state_dict().items():
        if k.endswith(('running_mean', 'running_var')):
            close(x, new_sd['mask_branch.' + k].numpy())


# -------------------------------------------------------------- mask head

MASK_KW = dict(in_channels=8, in_stride=8, out_stride=4, dynamic_convs=3,
               dynamic_channels=8, topk_per_img=8, pairwise_warmup=100)


def test_decode():
    rng = np.random.RandomState(8)
    b, k, hm, wm = 2, 5, 12, 14
    feat = rng.randn(b, hm, wm, 8).astype(np.float32)
    params = (rng.randn(b, k, 169) * 0.5).astype(np.float32)
    coors = (rng.rand(b, k, 2) * 100).astype(np.float32)
    levels = rng.randint(0, 5, (b, k))
    jm = jhead.CondInstMaskHead(**MASK_KW)
    want = jm.decode(jnp.asarray(feat), jnp.asarray(params),
                     jnp.asarray(coors), jnp.asarray(levels))
    tm = thead.CondInstMaskHead(bbox_head_channels=32, **MASK_KW)
    got = tm.decode(t(nchw(feat)), t(params), t(coors), t(levels).long())
    assert tuple(got.shape) == (b, k, 2 * hm, 2 * wm)
    close(got, want)


def test_color_similarity_and_box_bitmasks():
    rng = np.random.RandomState(9)
    b, h, w = 2, 64, 96
    images = (rng.rand(b, h, w, 3) * 4 - 2).astype(np.float32)
    shapes = np.array([[64, 96], [48, 80]], np.int32)
    removed = np.array([3, 5], np.int32)
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    jm = jhead.CondInstMaskHead(**MASK_KW)
    tm = thead.CondInstMaskHead(bbox_head_channels=32, **MASK_KW)
    w_sim, w_mask = jm.color_similarity_targets(
        jnp.asarray(images), mean, std, jnp.asarray(shapes),
        jnp.asarray(removed))
    g_sim, g_mask = tm.color_similarity_targets(
        t(nchw(images)), mean, std, t(shapes), t(removed))
    close(g_sim, w_sim)
    np.testing.assert_array_equal(g_mask.numpy(), np.asarray(w_mask))

    boxes = (rng.rand(b, 6, 4) * 60).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    np.testing.assert_array_equal(
        tm.box_bitmasks(t(boxes), 16, 24).numpy(),
        np.asarray(jm.box_bitmasks(jnp.asarray(boxes), 16, 24)))


@pytest.mark.parametrize('factor', [2, 4])
def test_aligned_bilinear(factor):
    x = np.random.RandomState(factor).randn(2, 7, 9, 3).astype(np.float32)
    close(aligned_bilinear(t(nchw(x)), factor),
          nchw(j_bilinear(jnp.asarray(x), factor)))


def test_projection_term_value_and_grad():
    rng = np.random.RandomState(10)
    scores = rng.rand(6, 12, 16).astype(np.float32)
    masks = (rng.rand(6, 12, 16) > 0.6).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 0, 1], bool)
    want = jax.value_and_grad(lambda s: j_project(
        s, jnp.asarray(masks), jnp.asarray(valid)))(jnp.asarray(scores))
    x = t(scores).requires_grad_(True)
    got = compute_project_term(x, t(masks), t(valid))
    got.backward()
    close(got, want[0])
    close(x.grad, want[1])


def test_mask_head_loss():
    rng = np.random.RandomState(11)
    b, k, h, w = 2, 8, 24, 32
    logits = (rng.randn(b, k, h, w) * 2).astype(np.float32)
    boxes = (rng.rand(b, k, 4) * 60).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2]
    valid = rng.rand(b, k) > 0.3
    sim = rng.rand(b, 8, h, w).astype(np.float32)
    jm = jhead.CondInstMaskHead(**MASK_KW)
    tm = thead.CondInstMaskHead(bbox_head_channels=32, **MASK_KW)
    want = jm.loss(jnp.asarray(logits), jnp.asarray(boxes),
                   jnp.asarray(valid), jnp.asarray(sim),
                   jnp.asarray(50, jnp.int32))
    got = tm.loss(t(logits), t(boxes), t(valid), t(sim), 50)
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key])
