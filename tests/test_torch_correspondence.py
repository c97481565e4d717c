"""The port's DiscoBox correspondence ops against the JAX package, on the
CPU: RoIAlign (both JAX branches), the antialiased resize of
``jax.image.resize``, the corner-aligned bilinear resize, relu + L2 norm,
Sinkhorn, diagonal message passing, regularised Hough matching, InfoNCE,
and the object bank (appends with repeated classes and wrap-around,
retrieval). Inputs are made from a seed with numpy.

Tolerances: atol 1e-5 / rtol 1e-4 on values (fp32, summation order);
indices, validity flags and the bank's ``ptr`` / ``count`` exactly.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.ops import correspondence as jc
from boxinstseg_tpu.ops.roi_align import roi_align as j_roi_align
from boxinstseg_tpu.ops.upsample import interpolate_bilinear as j_interp

from boxinstseg_tpu_torch.ops import correspondence as tc
from boxinstseg_tpu_torch.ops.roi_align import roi_align
from boxinstseg_tpu_torch.ops.upsample import (interpolate_bilinear,
                                               resize_bilinear_antialias)

ATOL, RTOL = 1e-5, 1e-4


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               **{'atol': ATOL, 'rtol': RTOL, **kw})


def rois_for(rng, n, b, h, w, integer=False):
    x1 = rng.uniform(-3, w - 4, n)
    y1 = rng.uniform(-3, h - 4, n)
    x2 = x1 + rng.uniform(0.5, w / 2, n)
    y2 = y1 + rng.uniform(0.5, h / 2, n)
    boxes = np.stack([x1, y1, x2, y2], 1)
    if integer:
        boxes = np.round(boxes)
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
    idx = rng.randint(0, b, n)
    return np.concatenate([idx[:, None], boxes], 1).astype(np.float32)


# (B, H, W, C, N, out, patch): many samples take the JAX patch-table
# branch, few the direct-corner branch; the last case has fewer ROIs than
# images (the JAX preselect) and one channel, as the mask crops
@pytest.mark.parametrize('case', [(2, 9, 11, 3, 40, (7, 7), True),
                                  (2, 40, 56, 8, 4, (7, 7), False),
                                  (12, 30, 34, 1, 5, (14, 14), True)],
                         ids=['patch-table', 'direct-corners', 'preselect'])
def test_roi_align_matches_both_jax_branches(case):
    b, h, w, c, n, out, patch = case
    rng = np.random.RandomState(0)
    feat = rng.randn(b, h, w, c).astype(np.float32)
    rois = rois_for(rng, n, b, h, w, integer=c == 1)
    n_samples = n * out[0] * 2 * out[1] * 2
    assert patch == (4 * n_samples >= min(n, b) * (h + 1) * (w + 1))
    want = np.asarray(j_roi_align(jnp.asarray(feat), jnp.asarray(rois), out))
    got = roi_align(torch.from_numpy(feat).permute(0, 3, 1, 2),
                    torch.from_numpy(rois), out)
    close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize('shape,out', [((3, 28, 28), (7, 7)),
                                       ((2, 30, 17), (7, 9)),
                                       ((2, 5, 6), (10, 13))])
def test_antialiased_resize_matches_jax_image_resize(shape, out):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), shape[:1] + out, 'bilinear')
    close(resize_bilinear_antialias(torch.from_numpy(x), out).numpy(),
          np.asarray(want))


@pytest.mark.parametrize('out', [(9, 13), (200, 336), (37, 20)])
def test_interpolate_bilinear_align_corners_matches_jax(out):
    x = np.random.RandomState(2).randn(2, 37, 53, 3).astype(np.float32)
    want = j_interp(jnp.asarray(x), out, align_corners=True)
    got = interpolate_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), out,
                               align_corners=True)
    close(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_relu_l2_norm_sinkhorn_and_pass_message_match_jax():
    rng = np.random.RandomState(3)
    f = rng.randn(4, 7, 7, 16).astype(np.float32)
    close(tc.relu_l2_norm(torch.from_numpy(f)).numpy(),
          np.asarray(jc.relu_l2_norm(jnp.asarray(f))))
    mu = rng.rand(2, 6).astype(np.float32) + 0.1
    nu = rng.rand(2, 5).astype(np.float32) + 0.1
    cost = rng.rand(2, 6, 5).astype(np.float32)
    close(tc.sinkhorn(*map(torch.from_numpy, (mu, nu, cost)), 0.5, 20)
          .numpy(), np.asarray(jc.sinkhorn(mu, nu, cost, 0.5, 20)))
    t = rng.rand(3, 20, 20).astype(np.float32)
    close(tc.pass_message(torch.from_numpy(t), (4, 5)).numpy(),
          np.asarray(jc.pass_message(jnp.asarray(t), (4, 5))))


@pytest.mark.parametrize('dist_kernel,num_iter', [(9, 3), (5, 2)])
def test_solve_correspondence_and_info_nce_match_jax(dist_kernel, num_iter):
    rng = np.random.RandomState(4)
    q = np.abs(rng.randn(6, 49, 16)).astype(np.float32)
    k = np.abs(rng.randn(6, 49, 16)).astype(np.float32)
    cu_j, t_j = jc.solve_correspondence(jnp.asarray(q), jnp.asarray(k),
                                        (7, 7), num_iter=num_iter,
                                        dist_kernel=dist_kernel)
    cu_t, t_t = tc.solve_correspondence(torch.from_numpy(q),
                                        torch.from_numpy(k), (7, 7),
                                        num_iter=num_iter,
                                        dist_kernel=dist_kernel)
    close(cu_t.numpy(), np.asarray(cu_j))
    close(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(t_t.argmax(-1).numpy(),
                                  np.asarray(t_j).argmax(-1))
    valid = np.array([True, False, True, True, False, True])
    soft = jax.nn.softmax(cu_j, -1)
    want = jc.info_nce_loss(soft, t_j, jnp.asarray(valid))
    got = tc.info_nce_loss(torch.softmax(cu_t, -1), t_t,
                           torch.from_numpy(valid))
    close(got.item(), float(want))
    # the batched form the head uses: (Q, R) pairs, one loss per query
    per_q = tc.info_nce_loss(torch.softmax(cu_t, -1).reshape(2, 3, 49, 49),
                             t_t.reshape(2, 3, 49, 49),
                             torch.from_numpy(valid.reshape(2, 3)))
    for i in range(2):
        want_i = jc.info_nce_loss(soft[3 * i:3 * i + 3], t_j[3 * i:3 * i + 3],
                                  jnp.asarray(valid[3 * i:3 * i + 3]))
        close(per_q[i].item(), float(want_i))


def to_torch_bank(bank):
    return tc.ObjectBank(*[torch.from_numpy(np.array(x)) for x in bank])


def assert_banks_equal(tbank, jbank):
    for name, got, want in zip(jbank._fields, tbank, jbank):
        if name in ('ptr', 'count'):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)
        else:
            close(got.numpy(), np.asarray(want), err_msg=name)


def append_inputs(rng, n, classes, fh=3, fw=3, d=4, mh=6, mw=6):
    return (rng.randint(0, classes, n).astype(np.int32),
            rng.randn(n, fh, fw, d).astype(np.float32),
            rng.rand(n, mh, mw).astype(np.float32),
            rng.rand(n, 4).astype(np.float32) * 20,
            rng.rand(n) > 0.3)


def test_bank_append_matches_jax_loop_with_repeats_and_wraparound():
    rng = np.random.RandomState(5)
    classes, length = 3, 7
    jbank = jc.create_object_bank(classes, length, (3, 3), (6, 6), 4)
    tbank = to_torch_bank(jbank)
    for call in range(8):
        items = append_inputs(rng, 6, classes)
        if call == 0:
            items[0][:] = 1           # one class six times in one call
            items[4][:] = True
        jbank = jc.bank_append(jbank, *map(jnp.asarray, items))
        tc.bank_append(tbank, *map(torch.from_numpy, items))
        assert_banks_equal(tbank, jbank)
    # every class wrapped at least once
    assert (np.asarray(jbank.count) > length).all()


def test_bank_append_refuses_a_call_that_could_wrap():
    bank = tc.create_object_bank(2, 4, (3, 3), (6, 6), 4)
    items = append_inputs(np.random.RandomState(6), 4, 2)
    with pytest.raises(ValueError, match='could wrap'):
        tc.bank_append(bank, *map(torch.from_numpy, items))


def test_bank_retrieve_batch_matches_jax():
    rng = np.random.RandomState(7)
    # class 3 stays empty, so its query retrieves nothing
    classes, length, q = 4, 9, 5
    jbank = jc.create_object_bank(classes, length, (7, 7), (28, 28), 8)
    # bank masks are boxes near the queries' so that the IoU gates pass
    for _ in range(2):
        labels = rng.randint(0, 3, 8).astype(np.int32)
        feats = np.asarray(jc.relu_l2_norm(jnp.asarray(
            np.abs(rng.randn(8, 7, 7, 8)).astype(np.float32) + 0.5)))
        masks = np.zeros((8, 28, 28), np.float32)
        for i in range(8):
            y, x = rng.randint(2, 6, 2)
            masks[i, y:y + 18, x:x + 16] = rng.uniform(0.6, 1.0)
        boxes = np.array([[0, 0, 16, 18]] * 8, np.float32) \
            + rng.rand(8, 4).astype(np.float32)
        jbank = jc.bank_append(jbank, *map(jnp.asarray, (
            labels, feats, masks, boxes, np.ones(8, bool))))
    tbank = to_torch_bank(jbank)
    q_labels = np.array([0, 1, 2, 1, 3], np.int32)
    q_feat = np.asarray(jc.relu_l2_norm(jnp.asarray(
        np.abs(rng.randn(q, 7, 7, 8)).astype(np.float32) + 0.5)))
    q_mask = np.zeros((q, 28, 28), np.float32)
    q_mask[:, 4:22, 4:20] = 0.9
    q_box = np.array([[0, 0, 16, 18]] * q, np.float32)
    kw = dict(fg_iou_thresh=0.5, bg_iou_thresh=0.5, appear_thresh=0.3,
              ratio_range=(0.5, 2.0), max_retrieval=3)
    want = jc.bank_retrieve_batch(jbank, *map(jnp.asarray, (
        q_labels, q_feat, q_mask, q_box)), **kw)
    got = tc.bank_retrieve_batch(tbank, *map(torch.from_numpy, (
        q_labels, q_feat, q_mask, q_box)), **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < np.asarray(want[2]).sum() < want[2].size
    close(got[0].numpy(), np.asarray(want[0]))
    close(got[1].numpy(), np.asarray(want[1]))
    # the one-query form
    one = jc.bank_retrieve(jbank, jnp.asarray(q_labels[1]),
                           jnp.asarray(q_feat[1]), jnp.asarray(q_mask[1]),
                           jnp.asarray(q_box[1]), **kw)
    got1 = tc.bank_retrieve(tbank, torch.tensor(q_labels[1]),
                            torch.from_numpy(q_feat[1]),
                            torch.from_numpy(q_mask[1]),
                            torch.from_numpy(q_box[1]), **kw)
    np.testing.assert_array_equal(got1[2].numpy(), np.asarray(one[2]))
    close(got1[0].numpy(), np.asarray(one[0]))
    close(got1[1].numpy(), np.asarray(one[1]))
