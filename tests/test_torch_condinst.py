"""Fully supervised CondInst (``mask_head.boxinst_enabled`` False) with the
semantic head ``CondInstSegmHead`` against the JAX package on the CPU.

A tiny CondInst (ResNet-18, narrow FPN and heads, a one-conv semantic
head) with the same weights (JAX init converted by ``params_from_jax``,
the semantic head's BN statistics included) and the same seeded batch with
stride-1 GT masks (ellipses inside the boxes, some overlapping):

- ``loss_cls``, ``loss_bbox``, ``loss_centerness`` and the dice
  ``loss_mask`` equal JAX ``CondInst.loss`` on the same stride-1 masks
  (atol 1e-5, rtol 1e-4);
- ``loss_segm`` equals JAX ``CondInstSegmHead.loss(..., mask_stride=1)`` on
  JAX's own ``segm_pred``: each JAX loss function is held at the input on
  which it is right, since the JAX detector passes stride-1 masks to the
  semantic loss with its default ``mask_stride=4`` (ROADMAP F8);
- the semantic loss alone on the same logits at mask strides 1 and 4, and
  ``DiceLoss``, against JAX;
- F8 pinned: JAX ``CondInst.loss`` on the batcher's stride-4 masks raises
  (or, once repaired, gives finite losses);
- ``train_detector`` feeds a supervised CondInst stride-1 masks from the
  loader, and every other model stride 4.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boxinstseg_tpu.engine import init_variables
from boxinstseg_tpu.models.dense_heads.condinst_head import \
    CondInstSegmHead as JSegmHead
from boxinstseg_tpu.models.losses.dice_loss import DiceLoss as JDiceLoss
from boxinstseg_tpu.registry import build_detector as j_build
from test_torch_slice import make_batch as box_batch, tiny_cfg, torch_batch

from boxinstseg_tpu_torch.apis.train import (build_train_loader,
                                             mask_stride, train_detector)
from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.models.dense_heads.condinst_head import \
    CondInstSegmHead
from boxinstseg_tpu_torch.models.losses import DiceLoss
from boxinstseg_tpu_torch.registry import build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax

ATOL, RTOL = 1e-5, 1e-4


def supervised_cfg():
    """The tiny CondInst of tests/test_torch_slice.py, mask-supervised, with
    a semantic head on P3."""
    cfg = tiny_cfg()
    cfg['mask_head'] = dict(cfg['mask_head'], boxinst_enabled=False)
    cfg['segm_head'] = dict(type='CondInstSegmHead', num_classes=4,
                            in_channels=32, in_stride=8, stacked_convs=1,
                            feat_channels=16)
    return cfg


def ellipse_masks(boxes, valid, h, w):
    """(B, G, h, w) uint8: an ellipse inscribed in each valid box."""
    ys, xs = np.mgrid[:h, :w] + 0.5
    out = np.zeros(boxes.shape[:2] + (h, w), np.uint8)
    for i, g in zip(*np.nonzero(valid)):
        x1, y1, x2, y2 = boxes[i, g]
        cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, \
            (y2 - y1) / 2
        out[i, g] = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1
    return out


def make_batch(seed):
    """tests/test_torch_slice.py's batch (NHWC) with stride-1 GT masks."""
    batch = box_batch(seed)
    h, w = batch['image'].shape[1:3]
    batch['gt_masks'] = ellipse_masks(batch['gt_bboxes'], batch['gt_valid'],
                                      h, w)
    return batch


@pytest.fixture(scope='module')
def pair():
    """(jax model, jax variables, port model) with the same weights."""
    jm = j_build(supervised_cfg())
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)},
                       {k: jnp.asarray(x) for k, x in make_batch(0).items()},
                       jnp.zeros((), jnp.int32), method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    assert 'segm_head_m' in v['batch_stats']
    tm = build_detector(supervised_cfg())
    tm.load_state_dict(params_from_jax(v['params'], v['batch_stats']),
                       strict=True)
    return jm, v, tm.train()


def _jax_losses(m, b, it):
    """JAX ``CondInst.loss`` and its semantic head's loss at mask stride 1
    on the same forward's ``segm_pred``."""
    losses = m.loss(b, it)
    segm_pred = m.segm_head_m(m.extract_feat(b['image'], train=True)[0],
                              train=True)
    return losses, m.segm_head_m.loss(segm_pred, b['gt_masks'],
                                      b['gt_labels'], b['gt_valid'],
                                      mask_stride=1)


def test_supervised_losses_match_the_jax_loss_functions(pair):
    jm, v, tm = pair
    batch = make_batch(1)
    assert int(batch['gt_valid'].sum()) >= 4
    (want, segm), _ = jax.jit(lambda v, b: jm.apply(
        v, b, jnp.asarray(50, jnp.int32), method=_jax_losses,
        mutable=['batch_stats']))(v, {k: jnp.asarray(x)
                                      for k, x in batch.items()})
    state = {k: x.clone() for k, x in tm.state_dict().items()}
    with torch.no_grad():
        got = tm.loss(torch_batch(batch), 50)
    tm.load_state_dict(state)
    assert set(got) == set(want) == {'loss_cls', 'loss_bbox',
                                     'loss_centerness', 'loss_mask',
                                     'loss_segm'}
    for k in ('loss_cls', 'loss_bbox', 'loss_centerness', 'loss_mask'):
        assert got[k].item() == pytest.approx(float(want[k]), rel=RTOL,
                                               abs=ATOL), k
    assert got['loss_segm'].item() == pytest.approx(
        float(segm['loss_segm']), rel=RTOL, abs=ATOL)
    assert 0 < float(want['loss_mask']) < 1


@pytest.mark.parametrize('stride', [1, 4])
def test_semantic_loss_matches_jax_on_the_same_logits(stride):
    rng = np.random.RandomState(stride)
    batch = make_batch(2)
    masks = batch['gt_masks'][:, :, ::stride, ::stride]
    b, h, w = 2, 16, 20
    logits = rng.randn(b, h, w, 4).astype(np.float32) * 2
    jhead = JSegmHead(num_classes=4, in_stride=8)
    want = jhead.loss(jnp.asarray(logits), jnp.asarray(masks),
                      jnp.asarray(batch['gt_labels']),
                      jnp.asarray(batch['gt_valid']), mask_stride=stride)
    head = CondInstSegmHead(num_classes=4, in_channels=8, in_stride=8)
    got = head.loss(torch.from_numpy(logits).permute(0, 3, 1, 2),
                    torch.from_numpy(masks),
                    torch.from_numpy(batch['gt_labels']),
                    torch.from_numpy(batch['gt_valid']), mask_stride=stride)
    assert got['loss_segm'].item() == pytest.approx(
        float(want['loss_segm']), rel=RTOL, abs=ATOL)


def test_dice_loss_matches_jax():
    rng = np.random.RandomState(0)
    pred = rng.randn(6, 12, 10).astype(np.float32)
    target = (rng.rand(6, 12, 10) > 0.6).astype(np.float32)
    weight = rng.rand(6).astype(np.float32)
    for kwargs in (dict(), dict(weight=weight, avg_factor=2.5)):
        want = JDiceLoss(loss_weight=2.0)(
            jnp.asarray(pred), jnp.asarray(target),
            **{k: jnp.asarray(x) for k, x in kwargs.items()})
        got = DiceLoss(loss_weight=2.0)(
            torch.from_numpy(pred), torch.from_numpy(target),
            **{k: torch.as_tensor(x) for k, x in kwargs.items()})
        assert got.item() == pytest.approx(float(want), rel=1e-5)


def test_jax_loss_on_the_batchers_stride_4_masks_pins_f8(pair):
    """ROADMAP F8: the JAX train loop batches supervised CondInst's masks
    at stride 4, and its dice branch samples them as if at stride 1. This
    holds while that stands; were the JAX package repaired, the losses
    would have to be finite instead."""
    jm, v, _ = pair
    batch = make_batch(1)
    batch['gt_masks'] = batch['gt_masks'][:, :, ::4, ::4]
    batch = {k: jnp.asarray(x) for k, x in batch.items()}
    loss = jax.jit(lambda v, b: jm.apply(
        v, b, jnp.asarray(50, jnp.int32), method=jm.loss,
        mutable=['batch_stats'])[0])
    try:
        jax.eval_shape(loss, v, batch)       # the fault shows in tracing
    except TypeError as err:
        assert 'incompatible shapes' in str(err)
        return
    assert all(np.isfinite(float(x)) for x in loss(v, batch).values())


class _MaskDataset:
    """TrainLoader's dataset interface: seeded images with two boxes and
    their (N, H, W) masks."""

    def __init__(self, n=4):
        self.flag = np.ones(n, np.uint8)
        self.n = n

    def __len__(self):
        return self.n

    def prepare(self, idx, rng, scale=None):
        img = rng.rand(64, 96, 3).astype(np.float32) * 4 - 2
        boxes = np.array([[8, 8, 50, 40], [30, 20, 90, 60]], np.float32)
        masks = ellipse_masks(boxes[None], np.ones((1, 2), bool), 64, 96)[0]
        return dict(img=img, img_shape=img.shape, ori_shape=img.shape,
                    gt_bboxes=boxes, gt_labels=np.array([1, 3]),
                    gt_masks=masks)


def test_train_detector_feeds_stride_1_masks_to_supervised_condinst(
        tmp_path):
    cfg = Config.fromdict(dict(
        model=supervised_cfg(),
        data=dict(samples_per_gpu=2, workers_per_gpu=1),
        optimizer=dict(type='SGD', lr=0.01, momentum=0.9),
        runner=dict(type='IterBasedRunner', max_iters=2),
        canvases=[(64, 96)], max_gts=4, work_dir=str(tmp_path)))
    assert mask_stride(cfg) == 1
    batches = iter(build_train_loader(cfg, _MaskDataset()))
    try:
        first = next(batches)
    finally:
        batches.close()
    assert first['gt_masks'].shape == (2, 4, 64, 96)
    assert first['gt_masks'][:, :2].sum() > 0
    torch.manual_seed(0)
    result = train_detector(build_detector(cfg.model), _MaskDataset(), cfg,
                            device='cpu')
    assert result.step == 2
    for h in result.history:
        assert {'loss_mask', 'loss_segm'} <= set(h)
        assert all(np.isfinite(v) for v in h.values())
    for other in (tiny_cfg(), dict(type='Box2Mask')):
        assert mask_stride(Config.fromdict(dict(model=other))) == 4
