"""The port's prediction path against the JAX package, on the CPU.

- ``greedy_nms``, ``mask_matrix_nms`` and ``points_nms_2x2`` against the
  JAX ops on seeded boxes and masks in overlapping clusters, with several
  labels and padded rows: kept indices and validity exactly, decayed
  scores within atol 1e-6; ``top_k`` against ``jax.lax.top_k`` on values
  full of ties: indices exactly;
- ``CondInst.predict`` against the JAX ``CondInst.predict``: a tiny
  BoxInst (ResNet-18, 32-channel FPN) with the same weights
  (``params_from_jax``), random BN statistics (frozen backbone and the
  mask branch in eval mode) and a box regression scaled so that the boxes
  are a stride or two wide;
- the DiscoBox ``predict`` (points NMS, mask decode, matrix NMS) against
  the JAX one, the tiny DiscoBox of ``tests/test_discobox_model.py``
  with its kernel branch's last conv scaled by 10 so that the mask scores
  spread around ``mask_thr``; and, under the bf16 policy, the DiscoBox
  ``get_seg`` (selection, decode, matrix NMS) in fp32, exactly as
  without autocast on the same head outputs.

Both predicts run with thresholds low enough that every image keeps at
least 10 detections. Top-k breaks ties in another order than
``jax.lax.top_k`` (the zero-score padding), so only valid slots are
compared: validity and labels exactly; boxes and scores within rtol 1e-4
/ atol 1e-5; masks within atol 1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.engine import init_variables
from boxinstseg_tpu.ops import nms as jnms
from boxinstseg_tpu.registry import build_detector as j_build
from test_discobox_model import synth_batch as disco_batch
from test_discobox_model import tiny_cfg as tiny_disco_cfg
from test_torch_slice import make_batch, randomize_stats, tiny_cfg

from boxinstseg_tpu_torch.engine.train_state import autocast_bf16
from boxinstseg_tpu_torch.ops import nms as tnms
from boxinstseg_tpu_torch.registry import build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax

RTOL, ATOL = 1e-4, 1e-5
MIN_DETS = 10


def cluster_boxes(rng, b, p, clusters=4, labels=3):
    """(b, p, 4) boxes jittered around a few centres, labels, scores;
    the last rows of each image are padding (zero box, score 0) and a few
    scores are negative."""
    boxes = np.zeros((b, p, 4), np.float32)
    for i in range(b):
        centres = rng.uniform(20, 80, (clusters, 2))
        c = centres[rng.randint(0, clusters, p)]
        wh = rng.uniform(10, 30, (p, 2))
        xy = c + rng.randn(p, 2) * 4
        boxes[i] = np.concatenate([xy - wh / 2, xy + wh / 2], 1)
    scores = rng.rand(b, p).astype(np.float32)
    scores[rng.rand(b, p) < 0.1] *= -1
    lab = rng.randint(0, labels, (b, p)).astype(np.int32)
    for i in range(b):
        pad = rng.randint(0, p // 3)
        boxes[i, p - pad:] = 0
        scores[i, p - pad:] = 0
    return boxes, scores, lab


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('max_det', [5, 40])
def test_greedy_nms_matches_jax(seed, max_det):
    boxes, scores, labels = cluster_boxes(np.random.RandomState(seed), 3, 60)
    want_idx, want_valid = jax.vmap(
        lambda b, s, l: jnms.greedy_nms(b, s, l, 0.5, max_det))(
        boxes, scores, labels)
    got_idx, got_valid = tnms.greedy_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(labels), 0.5, max_det)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    if max_det == 40:
        # boxes were suppressed, and an image ran out of boxes
        kept = np.asarray(want_valid).sum(1)
        assert (kept < (scores > 0).sum(1)).all()
        assert (kept < max_det).any()


def test_greedy_nms_ties_go_to_the_lower_index():
    boxes = np.array([[[0, 0, 10, 10]] * 4 + [[50, 50, 60, 60]]],
                     np.float32)
    scores = np.array([[0.5, 0.9, 0.9, 0.9, 0.9]], np.float32)
    labels = np.array([[0, 0, 1, 0, 0]], np.int32)
    got_idx, got_valid = tnms.greedy_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(labels), 0.5, 4)
    want_idx, want_valid = jnms.greedy_nms(boxes[0], scores[0], labels[0],
                                           0.5, 4)
    assert got_idx[0].tolist() == np.asarray(want_idx).tolist() \
        == [1, 2, 4, 0]
    assert got_valid[0].tolist() == np.asarray(want_valid).tolist() \
        == [True, True, True, False]


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('k', [1, 50, 300])
def test_top_k_breaks_ties_as_jax(seed, k):
    # few distinct values, as bf16 scores give, and a zero padding
    rng = np.random.RandomState(seed)
    x = (rng.randint(0, 6, (3, 300)) / 8).astype(np.float32)
    x[:, 250:] = 0
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = tnms.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def cluster_masks(rng, b, n, h=24, w=32, labels=3):
    masks = np.zeros((b, n, h, w), np.float32)
    for i in range(b):
        centres = rng.randint(6, 20, (3, 2))
        for j in range(n):
            cy, cx = centres[rng.randint(0, 3)] + rng.randint(-3, 4, 2)
            hh, ww = rng.randint(3, 9, 2)
            masks[i, j, max(cy - hh, 0):cy + hh, max(cx - ww, 0):cx + ww] = 1
    scores = rng.rand(b, n).astype(np.float32)
    valid = rng.rand(b, n) < 0.8
    return masks, rng.randint(0, labels, (b, n)).astype(np.int32), scores, \
        valid


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('kernel', ['gaussian', 'linear'])
def test_mask_matrix_nms_matches_jax(seed, kernel):
    masks, labels, scores, valid = cluster_masks(np.random.RandomState(seed),
                                                 2, 30)
    # ties among valid scores, which the stable sort orders by index
    scores[:, 5] = scores[:, 9]
    want = jax.vmap(lambda m, l, s, v: jnms.mask_matrix_nms(
        m, l, s, v, kernel=kernel, sigma=2.0))(masks, labels, scores, valid)
    got = tnms.mask_matrix_nms(*(torch.from_numpy(x) for x in (
        masks, labels, scores, valid)), kernel=kernel, sigma=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    decayed = np.asarray(want) < np.where(valid, scores, 0) - 1e-3
    assert decayed.sum() > 5


@pytest.mark.parametrize('seed', [0, 1])
def test_points_nms_2x2_matches_jax(seed):
    rng = np.random.RandomState(seed)
    heat = rng.rand(2, 3, 9, 7).astype(np.float32)
    heat[0, 0, 2:4, 2:4] = 1.0            # a plateau: every cell keeps
    want = jnms.points_nms_2x2(heat)
    got = tnms.points_nms_2x2(torch.from_numpy(heat))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[0, 0, 2:4, 2:4] == 1.0).all()


def compare_valid(got, want, keys):
    """Validity and labels exactly, the other ``keys`` on valid slots. The
    valid scores must be unambiguous: within an image no two lie closer
    than twice the largest difference between the packages' scores, so
    that no near-tie decides their order."""
    np.testing.assert_array_equal(got['valid'], want['valid'])
    assert (want['valid'].sum(1) >= MIN_DETS).all(), want['valid'].sum(1)
    m = want['valid']
    err = np.abs(got['scores'][m] - want['scores'][m]).max()
    for s, v in zip(want['scores'], m):
        gap = np.diff(np.sort(s[v])).min()
        assert gap > 2 * err, (gap, err)
    np.testing.assert_array_equal(got['labels'][m], want['labels'][m])
    for k in keys:
        tol = dict(atol=ATOL, rtol=0) if k == 'masks' \
            else dict(atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got[k][m], want[k][m], err_msg=k, **tol)


def test_condinst_predict_matches_jax():
    cfg = tiny_cfg(1)
    cfg['test_cfg'] = dict(nms_pre=200, score_thr=0.003,
                           nms=dict(type='nms', iou_threshold=0.5),
                           max_per_img=20, pre_nms_limit=300)
    jm = j_build(cfg)
    batch = make_batch(0)
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)},
                       {k: jnp.asarray(x) for k, x in batch.items()},
                       jnp.zeros((), jnp.int32), method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, v)
    # boxes a stride or two wide around their points, so that they overlap
    reg = v['params']['bbox_head_m']['conv_reg']
    reg['kernel'] = reg['kernel'] * 30
    reg['bias'] = reg['bias'] + 1.5
    v = {'params': v['params'], 'batch_stats': randomize_stats(
        dict(v['batch_stats']), np.random.RandomState(1))}
    tm = build_detector(cfg)
    tm.load_state_dict(params_from_jax(v['params'], v['batch_stats']),
                       strict=True)
    pb = dict(image=batch['image'],
              img_shape=np.array([[120, 150], [100, 160]], np.int32),
              scale_factor=np.array([[2.0] * 4, [1.5] * 4], np.float32))
    want = jax.device_get(jax.jit(lambda v, b: jm.apply(
        v, b, method=jm.predict))(v, pb))
    tb = {k: torch.from_numpy(x) for k, x in pb.items()}
    tb['image'] = tb['image'].permute(0, 3, 1, 2).contiguous()
    got = {k: x.numpy() for k, x in tm.eval().predict(tb).items()}
    assert got['masks'].shape == want['masks'].shape == (2, 20, 32, 40)
    compare_valid(got, want, ('bboxes', 'scores', 'masks'))


def tiny_discobox():
    """The tiny DiscoBox in both packages with the same weights, the kernel
    branch's last conv scaled by 10; returns (jm, v, tm in eval mode, the
    NHWC image batch)."""
    cfg = tiny_disco_cfg()
    cfg['test_cfg'] = dict(nms_pre=50, score_thr=0.005, mask_thr=0.4,
                           filter_thr=0.002, kernel='gaussian', sigma=2.0,
                           max_per_img=20)
    jm = j_build(cfg)
    batch = disco_batch(np.random.RandomState(0))
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)}, batch,
                       jnp.zeros((), jnp.int32), None, None, method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, v)
    head = v['params']['bbox_head_m']
    head['solo_kernel'] = dict(head['solo_kernel'],
                               kernel=head['solo_kernel']['kernel'] * 10)
    tm = build_detector(cfg)
    tm.load_state_dict(params_from_jax(v['params'], v['batch_stats']),
                       strict=True)
    return jm, v, tm.eval(), np.asarray(batch['image'])


def test_discobox_predict_matches_jax():
    jm, v, tm, image = tiny_discobox()
    want = jax.device_get(jax.jit(lambda v, x: jm.apply(
        v, {'image': x}, method=jm.predict))(v, image))
    img = torch.from_numpy(image).permute(0, 3, 1, 2).contiguous()
    got = {k: x.numpy() for k, x in tm.predict({'image': img}).items()}

    # the compared masks lie off mask_thr by more than their tolerance
    m = want['valid']
    assert not (np.abs(got['masks'][m] - 0.4) < ATOL).any()
    assert got['masks'].shape == want['masks'].shape == (2, 20, 32, 32)
    compare_valid(got, want, ('scores', 'masks'))


def test_discobox_predict_under_bf16_keeps_get_seg_in_fp32():
    """Under the bf16 policy the network runs in bf16, but ``get_seg`` (the
    selection, the mask decode and the matrix NMS, whose mask products
    count pixels) runs in fp32: ``predict``'s output is exactly that of
    ``get_seg`` on the same head outputs with autocast off."""
    _, _, tm, image = tiny_discobox()
    img = torch.from_numpy(image).permute(0, 3, 1, 2).contiguous()
    seen = {}
    get_seg = tm.bbox_head.get_seg

    def spy(outs, mask_feat, test_cfg):
        seen.update(outs=outs, mask_feat=mask_feat)
        return get_seg(outs, mask_feat, test_cfg)

    tm.bbox_head.get_seg = spy
    with autocast_bf16('cpu', True):
        got = tm.predict({'image': img})
    del tm.bbox_head.get_seg
    fp32 = tm.predict({'image': img})
    assert seen['mask_feat'].dtype == torch.float32
    want = get_seg(seen['outs'], seen['mask_feat'], tm.test_cfg)
    assert (want['valid'].sum(1) >= MIN_DETS).all(), want['valid'].sum(1)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the network did run in bf16: its masks are not the fp32 ones
    assert not torch.allclose(got['masks'], fp32['masks'], atol=ATOL)
