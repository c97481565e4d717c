"""The port's DiscoBox training slice against the JAX package, on the CPU.

A tiny DiscoBox (ResNet-18, 32-channel FPN, the ``tiny_cfg`` of
``tests/test_discobox_model.py``; with the correspondence loss, the
``loss_corr`` block of its bank test) with the same weights (JAX init
converted by ``params_from_jax``) and the same seeded batch. The last conv
of the kernel branch is scaled by 30 in both packages, so that the mask
scores sit away from 0.5, where the CRF's binarisation would depend on the
last bits; the tests assert that no target pixel of the scores lies
within 1e-4 of 0.5.

- SOLO targets, the positive-cell sample and the ROI boxes: exactly;
- the CRF fixed point (K7's plain version here) against ``MeanFieldCRF``
  on the CPU and against ``crf_mean_field_pallas`` in interpret mode,
  from the JAX side's own kernel, scores and targets: exactly; the exp
  form with inter-image priors: exactly; ``build_kernel``: atol 1e-6;
- ``_paste_roi``, the head's forward and the mask feature head: atol 1e-5
  / rtol 1e-4;
- the loss dict with the gates shut and open (with the correspondence
  loss and a bank the JAX step filled), rtol 1e-4, and every parameter
  gradient (atol 5e-5 of its largest entry, rtol 1e-4);
- four teacher-student steps (``start_iter=2``, gates forced open, bank
  appends and retrieval), the port's ``TSTrainStep`` against the JAX
  package's ``make_ts_train_step``: losses, parameters, the EMA teacher and
  ``avg_loss_ins`` (rtol 1e-4, atol 1e-6), the bank's ``ptr`` and
  ``count`` exactly;
- ``params_from_jax`` round-trips through ``convert_reference_checkpoint``;
- ``train_detector`` takes the teacher-student step and saves the teacher
  and the bank.
"""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boxinstseg_tpu.core.targets import solo as jsolo
from boxinstseg_tpu.engine import (build_optimizer as j_optimizer,
                                   create_train_state, init_variables,
                                   make_ts_train_step as j_ts_step,
                                   step_lr_schedule)
from boxinstseg_tpu.models.dense_heads import discobox_head as jdh
from boxinstseg_tpu.ops import correspondence as jc
from boxinstseg_tpu.ops.pallas_kernels import crf_mean_field_pallas
from boxinstseg_tpu.registry import build_detector as j_build
from boxinstseg_tpu.utils.checkpoint_convert import \
    convert_reference_checkpoint
from test_discobox_model import NUM_CLASSES, synth_batch, tiny_cfg

from boxinstseg_tpu_torch.core.targets import solo as tsolo
from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
from boxinstseg_tpu_torch.engine.train_state import TSTrainStep
from boxinstseg_tpu_torch.models.dense_heads import discobox_head as tdh
from boxinstseg_tpu_torch.ops import correspondence as tc
from boxinstseg_tpu_torch.ops.crf import crf_mean_field_plain
from boxinstseg_tpu_torch.registry import build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax

ATOL, RTOL = 1e-5, 1e-4
# parameter gradients: atol of their largest entry; the backbone's sums
# over four loss terms run in another order (up to 2.4e-5 of the largest
# entry seen for the CRF term alone)
GRAD_ATOL = 5e-5
KERNEL_SCALE = 30.0
BANK_LEN = 8


def corr_cfg():
    cfg = tiny_cfg()
    cfg['bbox_head']['loss_corr'] = dict(
        type='InfoNCE', loss_weight=1.0, corr_exp=1.0, corr_eps=0.05,
        gaussian_filter_size=3, low_score=0.3, corr_num_iter=2,
        corr_num_smooth_iter=1, dist_kernel=5,
        obj_bank=dict(len_object_queues=BANK_LEN, fg_iou_thresh=0.5,
                      bg_iou_thresh=0.5, ratio_range=[0.5, 2.0],
                      appear_thresh=0.5, max_retrieval_objs=5,
                      feat_height=7, feat_width=7, mask_height=14,
                      mask_width=14, min_size=2, num_gpu_bank=4))
    cfg['bbox_head']['max_corr_queries'] = 4
    return cfg


def new_bank():
    return jc.create_object_bank(NUM_CLASSES, BANK_LEN, (7, 7), (14, 14),
                                 feat_dim=32)


def torch_bank(bank):
    return tc.ObjectBank(*[torch.from_numpy(np.array(x)) for x in bank])


def torch_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out['image'] = out['image'].permute(0, 3, 1, 2).contiguous()
    return out


@pytest.fixture(scope='module')
def pair():
    """(jax model, jax variables, port model, jax batch) with the same
    weights, the correspondence loss on."""
    cfg = corr_cfg()
    jm = j_build(cfg)
    batch = synth_batch(np.random.RandomState(0))
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)}, batch,
                       jnp.zeros((), jnp.int32), None, None, new_bank(),
                       method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, v)
    head = v['params']['bbox_head_m']
    head['solo_kernel'] = dict(head['solo_kernel'],
                               kernel=head['solo_kernel']['kernel']
                               * KERNEL_SCALE)
    tm = build_detector(cfg)
    tm.load_state_dict(params_from_jax(v['params'], v['batch_stats']),
                       strict=True)
    return jm, v, tm.train(), batch


def test_solo_targets_sampling_and_boxes_match_jax(pair):
    jm, _, tm, batch = pair
    head = tm.bbox_head
    args = (batch['gt_bboxes'], batch['gt_labels'], batch['gt_valid'],
            batch['gt_masks'], (128, 128), head.num_grids,
            head.scale_ranges, head.sigma, NUM_CLASSES)
    want = jsolo.solo_targets(*args, mask_stride=4, min_mask_area=1.0)
    tb = torch_batch(batch)
    got = tsolo.solo_targets(tb['gt_bboxes'], tb['gt_labels'],
                             tb['gt_valid'], tb['gt_masks'], *args[4:],
                             mask_stride=4, min_mask_area=1.0)
    for name in ('cate_labels', 'cell_gt', 'num_pos', 'level_ids'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(want.num_pos) > 0
    for cap in (8, 3):
        w = jsolo.sample_positive_cells(want.cell_gt, cap)
        g = tsolo.sample_positive_cells(got.cell_gt, cap)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, gt_idx, _ = w
    box_mask = np.take_along_axis(np.asarray(batch['gt_masks'], np.float32),
                                  np.asarray(gt_idx)[..., None, None], 1)
    box_mask[0, 1] = 0                       # an empty mask
    want_boxes = jdh.DiscoBoxSOLOv2Head._mask_boxes(None, jnp.asarray(
        box_mask))
    np.testing.assert_array_equal(
        tdh.DiscoBoxSOLOv2Head._mask_boxes(torch.from_numpy(box_mask))
        .numpy(), np.asarray(want_boxes))


def crf_inputs(seed, b=2, k=5, h=16, w=24):
    rng = np.random.RandomState(seed)
    img = rng.rand(b, h, w, 3).astype(np.float32)
    x = rng.rand(b, k, h, w).astype(np.float32)
    x[np.abs(x - 0.5) < 1e-3] = 0.25          # no score at the threshold
    targets = np.zeros((b, k, h, w), np.float32)
    targets[:, :, 3:14, 4:20] = 1.0
    targets[1, 2] = 0.0                      # a plane without a target
    assert not ((np.abs(x - 0.5) < 1e-4) & (targets > 0)).any()
    return img, x, targets


@pytest.mark.parametrize('num_iter', [4, 10])
def test_crf_fixed_point_equals_jax_exactly(num_iter):
    img, x, targets = crf_inputs(1)
    jcrf = jdh.MeanFieldCRF(num_iter=num_iter)
    kernel = jcrf.build_kernel(jnp.asarray(img))
    want = np.asarray(jcrf(kernel, jnp.asarray(x), jnp.asarray(targets)))
    tcrf = tdh.MeanFieldCRF(num_iter=num_iter)
    got = tcrf(torch.from_numpy(np.asarray(kernel)), torch.from_numpy(x),
               torch.from_numpy(targets)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < targets.sum()
    # the Pallas kernel in interpret mode, from the same thresh and bin0
    kv = 0.0
    h, w = x.shape[-2:]
    for o, (dy, dx) in enumerate(jcrf.offsets):
        m = np.zeros((h, w), np.float32)
        m[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = 1.0
        kv = kv + np.asarray(kernel)[:, o] * m
    bin0 = (x * targets > 0.5).astype(np.float32)
    pallas = np.asarray(crf_mean_field_pallas(
        kernel, jnp.asarray(0.5 * kv), jnp.asarray(bin0),
        jnp.asarray(targets), jcrf.offsets, num_iter, k_tile=2,
        interpret=True))
    plain = crf_mean_field_plain(
        torch.from_numpy(np.asarray(kernel)), torch.from_numpy(0.5 * kv),
        torch.from_numpy(bin0), torch.from_numpy(targets), num_iter)
    np.testing.assert_array_equal(plain.numpy(), pallas)
    np.testing.assert_array_equal(pallas, want)


def test_build_kernel_and_iiu_crf_match_jax():
    img, x, targets = crf_inputs(2, k=3)
    jcrf = jdh.MeanFieldCRF(num_iter=5)
    tcrf = tdh.MeanFieldCRF(num_iter=5)
    kernel = jcrf.build_kernel(jnp.asarray(img))
    np.testing.assert_allclose(
        tcrf.build_kernel(torch.from_numpy(img).permute(0, 3, 1, 2)).numpy(),
        np.asarray(kernel), atol=1e-6, rtol=0)
    iiu = np.random.RandomState(3).rand(2, 3, 2, 16, 24).astype(
        np.float32) * 20
    want = np.asarray(jcrf(kernel, jnp.asarray(x), jnp.asarray(targets),
                           iiu=jnp.asarray(iiu)))
    got = tcrf(torch.from_numpy(np.asarray(kernel)), torch.from_numpy(x),
               torch.from_numpy(targets), iiu=torch.from_numpy(iiu))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = np.asarray(jcrf(kernel, jnp.asarray(x), jnp.asarray(targets)))
    assert (want != plain).any()             # the priors moved labels


def test_paste_roi_matches_jax():
    rng = np.random.RandomState(4)
    ci = rng.rand(3, 2, 14, 14).astype(np.float32)
    boxes = np.array([[3, 4, 20, 17], [0, 0, 32, 24], [10.5, 2, 11, 30]],
                     np.float32)
    got = tdh._paste_roi(torch.from_numpy(ci), torch.from_numpy(boxes), 24,
                         32)
    for i in range(3):
        want = jdh._paste_roi(jnp.asarray(ci[i]), jnp.asarray(boxes[i]), 24,
                              32)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)


def test_head_forward_and_mask_feature_match_jax(pair):
    jm, v, tm, batch = pair
    (outs, mask_feat) = jax.jit(lambda v, img: jm.apply(v, img, True))(
        v, batch['image'])
    with torch.no_grad():
        t_outs, t_mask_feat = tm(torch_batch(batch)['image'])
    for key in ('kernels', 'cates'):
        np.testing.assert_allclose(t_outs[key].numpy(),
                                   np.asarray(outs[key]), atol=ATOL,
                                   rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(t_mask_feat.permute(0, 2, 3, 1).numpy(),
                               np.asarray(mask_feat), atol=3 * ATOL,
                               rtol=RTOL)


def filled_bank(jm, v, batch, gates, calls=3):
    """A bank filled by the JAX step's own appends of ``batch``."""
    bank = new_bank()
    fn = jax.jit(lambda v, b, bank: jm.apply(
        v, b, jnp.zeros((), jnp.int32), None, gates, bank,
        method=jm.loss)['_corr_append'])
    for _ in range(calls):
        ap = fn(v, batch, bank)
        bank = jc.bank_append(bank, ap['labels'], ap['feats'], ap['masks'],
                              ap['boxes'], ap['valid'])
    return bank


def assert_scores_unambiguous(tm, tb):
    with torch.no_grad():
        outs, mask_feat = tm(tb['image'])
        head = tm.bbox_head
        t = tsolo.solo_targets(tb['gt_bboxes'], tb['gt_labels'],
                               tb['gt_valid'], tb['gt_masks'], (128, 128),
                               head.num_grids, head.scale_ranges, head.sigma,
                               NUM_CLASSES, min_mask_area=1.0)
        cell_idx, gt_idx, _ = tsolo.sample_positive_cells(t.cell_gt,
                                                          head.max_pos)
        e = outs['kernels'].shape[-1]
        scores = torch.sigmoid(head.decode_masks(mask_feat, torch.gather(
            outs['kernels'], 1, cell_idx[..., None].expand(-1, -1, e))))
        box = torch.gather(tb['gt_masks'].float(), 1, gt_idx[
            :, :, None, None].expand(-1, -1, *scores.shape[2:]))
    near = ((scores - 0.5).abs() < 1e-4) & (box > 0)
    assert not near.any(), 'seed puts mask scores at 0.5: ambiguous CRF'


@pytest.mark.parametrize('gates_open', [False, True],
                         ids=['gates-shut', 'gates-open'])
def test_loss_dict_and_gradients_match_jax(pair, gates_open):
    jm, v, tm, batch = pair
    g = 1.0 if gates_open else 0.0
    gates = dict(teacher=jnp.float32(0.0), ts=jnp.float32(g),
                 corr=jnp.float32(g))
    bank = filled_bank(jm, v, batch, dict(gates, corr=jnp.float32(1.0)))
    assert int(np.asarray(bank.count).sum()) >= 5

    def total(params, b):
        losses = jm.apply({'params': params,
                           'batch_stats': v['batch_stats']}, b,
                          jnp.zeros((), jnp.int32), None, gates, bank,
                          method=jm.loss)
        losses.pop('_corr_append')
        return sum(losses.values()), losses

    (_, want), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        v['params'], batch)
    tb = torch_batch(batch)
    assert_scores_unambiguous(tm, tb)
    tm.zero_grad(set_to_none=True)
    got = tm.loss(tb, 0, None, dict(ts=torch.tensor(g), corr=torch.tensor(g)),
                  torch_bank(bank))
    got.pop('_corr_append')
    sum(got.values()).backward()
    assert set(got) == set(want)
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), rel=RTOL,
                                              abs=1e-6), k
    if gates_open:
        assert float(want['loss_corr']) > 0 and float(want['loss_ts']) > 0
    else:
        assert float(want['loss_corr']) == 0 and float(want['loss_ts']) == 0
    jg = params_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                         v['batch_stats'])
    tg = {k: p.grad for k, p in tm.named_parameters()}
    assert set(tg) <= set(jg)
    for k, got_g in tg.items():
        want_g = jg[k].numpy()
        if got_g is None:                    # a frozen stage
            assert not want_g.any(), k
            continue
        ref = np.abs(want_g).max()
        np.testing.assert_allclose(got_g.numpy(), want_g,
                                   atol=GRAD_ATOL * max(ref, 1e-3),
                                   rtol=RTOL,
                                   err_msg=k)


def ema_gap(teacher, student):
    """Largest absolute difference between a teacher and a student
    parameter."""
    return max((t - s).abs().max().item() for t, s in
               zip(teacher.parameters(), student.parameters()))


def test_four_ts_steps_match_jax_train_step(pair):
    """start_iter 2: the replica copies the student after steps 0 and 1,
    lags from step 2, and the teacher's forward runs in step 3. Before each
    step avg_loss_ins is set to 0.1 in both packages, which opens the ts and
    corr gates, so the bank receives appends from step 0 and retrieval
    fires from step 2; the updated avg_loss_ins is compared after each
    step. The LR is 1e-4: with these steep scores a larger step lets the
    two packages' last-bit differences flip a mask pixel of the
    correspondence priors (a threshold at 0.5) by step 3; with the same
    parameters both give the same losses and gradients (the tests
    above)."""
    jm, v, _, batch = pair
    lr = 1e-4
    opt = dict(type='SGD', lr=lr, momentum=0.9, weight_decay=1e-4)
    tx = j_optimizer(opt, step_lr_schedule(lr, warmup=None, warmup_iters=0))
    state = create_train_state(jm, v, tx, ema=True, corr_state=new_bank())
    j_step = j_ts_step(jm, tx, momentum=0.9, start_iter=2, donate=False)

    tm = build_detector(corr_cfg())
    tm.load_state_dict(params_from_jax(v['params'], v['batch_stats']))
    optimizer = build_optimizer(opt, tm.named_parameters())
    t_step = TSTrainStep(tm, optimizer, lambda i: lr, momentum=0.9,
                         start_iter=2, bank=torch_bank(new_bank()))
    tb = torch_batch(batch)
    for i in range(4):
        state = state.replace(avg_loss_ins=jnp.asarray(0.1, jnp.float32))
        t_step.avg_loss_ins = torch.tensor(0.1)
        state, j_logs = j_step(state, batch)
        t_logs = t_step(tb, i)
        for k, want in j_logs.items():
            assert t_logs[k].item() == pytest.approx(float(want), rel=RTOL,
                                                     abs=1e-6), (i, k)
        assert t_logs['teacher_forward'].item() == float(i > 2)
        assert (ema_gap(t_step.teacher, tm) == 0) == (i < 2)
        assert t_step.avg_loss_ins.item() == pytest.approx(
            float(state.avg_loss_ins), rel=RTOL, abs=1e-6)
        np.testing.assert_array_equal(t_step.bank.ptr.numpy(),
                                      np.asarray(state.corr_state.ptr))
        np.testing.assert_array_equal(t_step.bank.count.numpy(),
                                      np.asarray(state.corr_state.count))
    assert float(j_logs['loss_corr']) > 0
    assert t_step.teacher_forwards == 1
    for jp, module in ((state.params, tm), (state.ema_params,
                                            t_step.teacher)):
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               v['batch_stats'])
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       rtol=RTOL, atol=1e-6, err_msg=k)
    for name in ('feat', 'mask', 'box'):
        np.testing.assert_allclose(
            getattr(t_step.bank, name).numpy(),
            np.asarray(getattr(state.corr_state, name)), atol=ATOL,
            err_msg=name)


def test_params_from_jax_round_trips_through_converter(pair):
    _, v, tm, _ = pair
    sd = params_from_jax(v['params'], v['batch_stats'])
    assert set(sd) == set(tm.state_dict())
    p, s = convert_reference_checkpoint(sd)
    for want, got in ((v['params'], p), (v['batch_stats'], s)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]),
                                          np.asarray(leaf))


class _TinyMaskDataset:
    """TrainLoader's dataset interface: seeded images with box masks."""

    def __init__(self, n=4):
        self.flag = np.ones(n, np.uint8)
        self.n = n

    def __len__(self):
        return self.n

    def prepare(self, idx, rng, scale=None):
        img = rng.rand(128, 128, 3).astype(np.float32) * 4 - 2
        boxes = np.array([[8, 8, 60, 50], [40, 30, 120, 110]], np.float32)
        masks = np.zeros((2, 128, 128), np.uint8)
        for m, (x1, y1, x2, y2) in zip(masks, boxes.astype(int)):
            m[y1:y2 + 1, x1:x2 + 1] = 1
        return dict(img=img, img_shape=img.shape, ori_shape=img.shape,
                    gt_bboxes=boxes, gt_labels=np.array([1, 3]),
                    gt_masks=masks)


def test_train_detector_takes_the_ts_step_and_saves_teacher_and_bank(
        tmp_path, monkeypatch):
    from boxinstseg_tpu_torch.apis.train import train_detector
    gaps, call = [], TSTrainStep.__call__

    def recorded(self, batch, i):
        logs = call(self, batch, i)
        gaps.append(ema_gap(self.teacher, self.model))
        return logs
    monkeypatch.setattr(TSTrainStep, '__call__', recorded)
    from boxinstseg_tpu_torch.config import Config
    cfg = Config.fromdict(dict(
        model=dict(corr_cfg(), type='DiscoBoxSOLOv2'),
        data=dict(samples_per_gpu=2, workers_per_gpu=1),
        optimizer=dict(type='SGD', lr=0.01, momentum=0.9,
                       weight_decay=1e-4),
        lr_config=dict(policy='fixed'),
        runner=dict(type='IterBasedRunner', max_iters=3),
        ts_cfg=dict(momentum=0.9, start_iter=1),
        with_gt_masks=True, canvases=[(128, 128)], max_gts=4,
        work_dir=str(tmp_path)))
    torch.manual_seed(0)
    model = build_detector(copy.deepcopy(cfg.model))
    result = train_detector(model, _TinyMaskDataset(), cfg, device='cpu')
    assert result.step == 3
    assert [h['teacher_forward'] for h in result.history] == [0, 0, 1]
    assert [g == 0 for g in gaps] == [True, False, False]
    assert all(np.isfinite(v) for h in result.history for v in h.values())
    assert result.history[0]['avg_loss_ins'] == pytest.approx(2.0)
    ckpt = torch.load(result.checkpoint, map_location='cpu')
    assert set(ckpt['teacher_state_dict']) == set(model.state_dict())
    assert ckpt['object_bank']['feat'].shape == (NUM_CLASSES, BANK_LEN, 7,
                                                 7, 32)
    assert 'avg_loss_ins' in (tmp_path / 'train.log').read_text()
