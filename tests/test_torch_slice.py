"""The PyTorch port's BoxInst training slice against the JAX package.

A tiny CondInst (ResNet-18, narrow FPN and heads) with the same weights
(JAX init converted by ``params_from_jax``) and the same seeded batch:

- the loss dict matches the JAX ``CondInst.loss`` (rtol 1e-4) and the
  sampled point indices match exactly;
- two SGD steps match ``make_train_step`` + ``build_optimizer``: losses,
  ``grad_norm`` and every updated parameter, frozen stages included
  (rtol 1e-4, atol 1e-6); a heavy-decay step moves the frozen stages by
  lr * wd * p exactly as optax does;
- ``params_from_jax`` round-trips through ``convert_reference_checkpoint``;
- importing every module of the port, running its CondInst, Box2Mask
  and DiscoBox train steps, and predicting, formatting, RLE-encoding and
  evaluating with each of them, with cv2 made unimportable, leaves JAX,
  flax and optax out of ``sys.modules`` (in a subprocess: this suite
  imports JAX);
- ``train_detector`` runs the loop on the CPU and saves ``_iter``, and
  applies the shipped DiscoBox config's ``fp16`` key as bf16 autocast;
- an error in the loader's producer thread reaches the consumer.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boxinstseg_tpu.engine import (build_lr_schedule as j_schedule,
                                   build_optimizer as j_optimizer,
                                   create_train_state, init_variables,
                                   make_train_step as j_train_step)
from boxinstseg_tpu.models.dense_heads.condinst_head import \
    CondInstBoxHead as JBoxHead
from boxinstseg_tpu.core.targets.fcos import \
    sample_positives_per_gt as j_sample
from boxinstseg_tpu.registry import build_detector as j_build
from boxinstseg_tpu.utils.checkpoint_convert import \
    convert_reference_checkpoint

from boxinstseg_tpu_torch.core.targets.fcos import sample_positives_per_gt
from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
from boxinstseg_tpu_torch.engine.schedules import build_lr_schedule
from boxinstseg_tpu_torch.engine.train_state import make_train_step
from boxinstseg_tpu_torch.models.dense_heads.condinst_head import \
    flatten_levels
from boxinstseg_tpu_torch.registry import build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN_L = os.path.join(
    ROOT, 'configs/box2mask/box2mask_swin-l-p4-w12-384-lsj_8x1_50e_coco.py')
H, W, G, B = 128, 160, 5, 2


def tiny_cfg(pairwise_warmup=100):
    return dict(
        type='CondInst',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, start_level=1,
                  add_extra_convs='on_output', num_outs=5,
                  relu_before_extra_convs=True),
        bbox_head=dict(type='CondInstBoxHead', num_classes=4,
                       in_channels=32, feat_channels=32, stacked_convs=1,
                       strides=[8, 16, 32, 64, 128],
                       norm_cfg=dict(type='GN', num_groups=4)),
        mask_branch=dict(type='CondInstMaskBranch', in_channels=32,
                         in_indices=[0, 1, 2], strides=[8, 16, 32],
                         branch_convs=1, branch_channels=16,
                         branch_out_channels=8),
        mask_head=dict(type='CondInstMaskHead', in_channels=8,
                       in_stride=8, out_stride=4, dynamic_convs=3,
                       dynamic_channels=8, topk_per_img=8,
                       max_proposals=-1, boxinst_enabled=True,
                       pairwise_warmup=pairwise_warmup))


def make_batch(seed):
    """Seeded numpy batch: NHWC image for JAX (the port takes NCHW)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.zeros((B, G), np.int32)
    valid = np.zeros((B, G), bool)
    for i in range(B):
        for g in range(rng.randint(1, G + 1)):
            x1, y1 = rng.randint(0, W - 40), rng.randint(0, H - 40)
            boxes[i, g] = (x1, y1, x1 + rng.randint(16, 40),
                           y1 + rng.randint(16, 40))
            labels[i, g] = rng.randint(0, 4)
            valid[i, g] = True
    return dict(image=rng.rand(B, H, W, 3).astype(np.float32) * 4 - 2,
                img_shape=np.array([[H, W]] * B, np.int32),
                pixels_removed=np.array([5] * B, np.int32),
                gt_bboxes=boxes, gt_labels=labels, gt_valid=valid)


def torch_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out['image'] = out['image'].permute(0, 3, 1, 2).contiguous()
    return out


def randomize_stats(tree, rng):
    """Random frozen-BN statistics, so the parity covers them."""
    return {k: randomize_stats(v, rng) if isinstance(v, dict) else (
        rng.uniform(0.5, 1.5, np.shape(v)) if k == 'var'
        else rng.randn(*np.shape(v)) * 0.1).astype(np.float32)
        for k, v in tree.items()}


@pytest.fixture(scope='module')
def pair():
    """(jax model, jax variables, port model) with the same weights."""
    cfg = tiny_cfg(pairwise_warmup=1)
    jm = j_build(cfg)
    batch = make_batch(0)
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)},
                       {k: jnp.asarray(x) for k, x in batch.items()},
                       jnp.zeros((), jnp.int32), method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, v)
    v = {'params': v['params'], 'batch_stats': dict(v['batch_stats'])}
    v['batch_stats']['backbone_m'] = randomize_stats(
        v['batch_stats']['backbone_m'], np.random.RandomState(1))
    tm = build_detector(cfg)
    tm.load_state_dict(params_from_jax(v['params'], v['batch_stats']),
                       strict=True)
    return jm, v, tm.train()


def test_loss_dict_and_sampling_match_jax(pair):
    jm, v, tm = pair
    batch = make_batch(1)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    def jax_losses_and_samples(m, b):
        losses = m.loss(b, jnp.asarray(50, jnp.int32))
        feats = m.extract_feat(b['image'], train=True)
        outs = m.bbox_head_m(feats, train=True)
        _, targets, _ = m.bbox_head_m.loss(outs, b['gt_bboxes'],
                                           b['gt_labels'], b['gt_valid'])
        cls = JBoxHead.flatten_levels(outs['cls'])
        ctr = JBoxHead.flatten_levels(outs['ctr'])[..., 0]
        score = jax.nn.sigmoid(cls).max(-1) * jax.nn.sigmoid(ctr)
        return losses, j_sample(score, targets.gt_inds, b['gt_valid'],
                                m.mask_head_m.capacity)

    (want, want_idx), _ = jax.jit(lambda v, b: jm.apply(
        v, b, method=jax_losses_and_samples, mutable=['batch_stats']))(v, jb)
    state = {k: x.clone() for k, x in tm.state_dict().items()}
    tb = torch_batch(batch)
    with torch.no_grad():
        got = tm.loss(tb, 50)
        outs, _ = tm(tb['image'])
        _, targets, _ = tm.bbox_head.loss(outs, tb['gt_bboxes'],
                                          tb['gt_labels'], tb['gt_valid'])
        score = torch.sigmoid(flatten_levels(outs['cls'])).amax(-1) * \
            torch.sigmoid(flatten_levels(outs['ctr'])[..., 0])
        got_idx = sample_positives_per_gt(score, targets.gt_inds,
                                          tb['gt_valid'],
                                          tm.mask_head.capacity)
    tm.load_state_dict(state)
    assert set(got) == set(want)
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), rel=1e-4), k
    assert float(want['loss_pairwise']) > 0
    for g, w in zip(got_idx, want_idx):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


OPT = dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4)
LR = dict(policy='step', warmup='linear', warmup_iters=4, warmup_ratio=0.5,
          step=[8, 11])


def _run_both(pair, opt, lr_cfg, steps):
    """``steps`` train steps in both packages; returns (jax logs, jax
    params, port logs, port state_dict)."""
    jm, v, _ = pair
    tm = build_detector(tiny_cfg(pairwise_warmup=1))
    tm.load_state_dict(params_from_jax(v['params'], v['batch_stats']))
    j_lr = j_schedule(lr_cfg, opt['lr'], 100, by_epoch=False)
    tx = j_optimizer(opt, j_lr, params_example=v['params'])
    state = create_train_state(jm, v, tx)
    j_step = j_train_step(jm, tx, donate=False)
    optimizer = build_optimizer(opt, tm.named_parameters())
    t_step = make_train_step(tm, optimizer, build_lr_schedule(
        lr_cfg, opt['lr'], 100, by_epoch=False))
    j_logs, t_logs = [], []
    for i in range(steps):
        batch = make_batch(10 + i)
        state, logs = j_step(state, {k: jnp.asarray(x)
                                     for k, x in batch.items()})
        j_logs.append({k: float(x) for k, x in logs.items()})
        t_logs.append({k: x.item() for k, x in
                       t_step(torch_batch(batch), i).items()})
    jp = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                         jax.tree_util.tree_map(np.asarray,
                                                state.batch_stats))
    return j_logs, jp, t_logs, tm.state_dict()


def test_two_sgd_steps_match_jax_train_step(pair):
    j_logs, jp, t_logs, sd = _run_both(pair, OPT, LR, 2)
    for jl, tl in zip(j_logs, t_logs):
        for k in jl:
            assert tl[k] == pytest.approx(jl[k], rel=1e-4, abs=1e-6), k
    assert j_logs[1]['loss_pairwise'] > 0
    for k, want in jp.items():
        if k.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_frozen_stages_decay_like_optax(pair):
    """Frozen stages get no gradient but SGD's weight decay still moves
    them (optax decays every leaf): heavy decay makes that visible."""
    opt = dict(type='SGD', lr=0.5, momentum=0.9, weight_decay=0.1)
    lr = dict(policy='fixed')
    _, jp, _, sd = _run_both(pair, opt, lr, 1)
    init = params_from_jax(pair[1]['params'], pair[1]['batch_stats'])
    frozen = [k for k in init if k.startswith(('backbone.conv1',
                                               'backbone.bn1.',
                                               'backbone.layer1.'))
              and not k.endswith(('running_mean', 'running_var'))]
    assert frozen
    for k in frozen:
        want = init[k].numpy() * (1 - 0.5 * 0.1)
        np.testing.assert_allclose(jp[k].numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(sd[k].numpy(), want, rtol=1e-6)


def test_params_from_jax_round_trips_through_converter(pair):
    _, v, tm = pair
    p, s = convert_reference_checkpoint(
        params_from_jax(v['params'], v['batch_stats']))
    for want, got in ((v['params'], p), (v['batch_stats'], s)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]),
                                          np.asarray(leaf))
    assert set(tm.state_dict()) == set(
        params_from_jax(v['params'], v['batch_stats']))


def tiny_box2mask_cfg():
    return dict(
        type='Box2Mask',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=-1),
        panoptic_head=dict(
            type='Box2MaskHead', in_channels=[64, 128, 256, 512],
            feat_channels=32, out_channels=32, num_things_classes=3,
            num_queries=6, pixel_decoder=dict(num_encoder_layers=1),
            transformer_decoder=dict(num_layers=2, transformerlayers=dict(
                attn_cfgs=dict(num_heads=4), feedforward_channels=32)),
            max_matched=2, tf_size=(12, 12)))


def tiny_discobox_cfg():
    return dict(
        type='DiscoBoxSOLOv2',
        backbone=dict(type='ResNet', depth=18, frozen_stages=1),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, start_level=0, num_outs=5),
        bbox_head=dict(
            type='DiscoBoxSOLOv2Head', num_classes=4, in_channels=32,
            seg_feat_channels=16, stacked_convs=1,
            scale_ranges=((1, 24), (12, 48), (24, 96), (48, 192),
                          (96, 2048)),
            num_grids=[8, 6, 4, 3, 2], ins_out_channels=16,
            loss_ts=dict(max_iter=3), max_pos=8, max_corr_queries=4,
            loss_corr=dict(corr_num_iter=2, dist_kernel=5, obj_bank=dict(
                len_object_queues=8, fg_iou_thresh=0.0, bg_iou_thresh=0.0,
                appear_thresh=-1.0, ratio_range=[0.0, 10.0],
                mask_height=14, mask_width=14, min_size=2))),
        mask_feat_head=dict(type='DiscoBoxMaskFeatHead', in_channels=32,
                            out_channels=16, num_classes=16,
                            norm_cfg=dict(type='GN', num_groups=8)))


def test_port_never_imports_jax_or_cv2():
    code = textwrap.dedent(f'''
        import sys
        sys.modules['cv2'] = None     # cv2 absent: importing it raises
        sys.path.insert(0, {ROOT!r})
        import torch
        import boxinstseg_tpu_torch
        from boxinstseg_tpu_torch.registry import build_detector
        from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
        from boxinstseg_tpu_torch.engine.train_state import make_train_step
        from boxinstseg_tpu_torch.apis import train  # noqa: F401
        cfg = {tiny_cfg(1)!r}
        model = build_detector(cfg)
        opt = build_optimizer(dict(type='SGD', lr=0.01, momentum=0.9),
                              model.named_parameters())
        step = make_train_step(model, opt, lambda i: 0.01)
        g = torch.Generator().manual_seed(0)
        boxes = torch.tensor([[[8., 8., 48., 40.]]] * 2)
        batch = dict(image=torch.randn(2, 3, 64, 96, generator=g),
                     img_shape=torch.tensor([[64, 96]] * 2),
                     pixels_removed=torch.tensor([2, 2]),
                     gt_bboxes=boxes, gt_labels=torch.zeros(2, 1).long(),
                     gt_valid=torch.ones(2, 1, dtype=torch.bool))
        logs = step(batch, 1)
        assert all(torch.isfinite(v) for v in logs.values()), logs

        # every module of the port, and the Box2Mask train path: AdamW
        # with paramwise multipliers through the tree filter, the host
        # MST and Hungarian solves, MSDA and LCM
        import pkgutil, importlib
        for mod in pkgutil.walk_packages(boxinstseg_tpu_torch.__path__,
                                         'boxinstseg_tpu_torch.'):
            importlib.import_module(mod.name)
        b2m = {tiny_box2mask_cfg()!r}
        model = build_detector(b2m)
        opt = build_optimizer(dict(
            type='AdamW', lr=1e-4, weight_decay=0.05,
            paramwise_cfg=dict(custom_keys=dict(backbone=dict(lr_mult=0.1)),
                               norm_decay_mult=0.0)),
            model.named_parameters())
        step = make_train_step(model, opt, lambda i: 1e-4,
                               dict(max_norm=0.01))
        masks = torch.zeros(2, 2, 16, 16)
        masks[:, 0, 2:9, 3:12] = 1
        masks[0, 1, 8:15, 1:6] = 1
        batch = dict(image=torch.randn(2, 3, 64, 64, generator=g),
                     gt_masks=masks, gt_labels=torch.tensor([[1, 2], [0, 0]]),
                     gt_valid=torch.tensor([[True, True], [True, False]]))
        logs = step(batch, 0)
        assert all(torch.isfinite(v) for v in logs.values()), logs
        assert 'd0.loss_levelset' in logs, sorted(logs)

        # the Swin path: the shipped Swin-L Box2Mask (built on the meta
        # device), a step of a tiny Swin Box2Mask through window attention
        # and its explicit backward, and predict
        import boxinstseg_tpu_torch.models.backbones.swin
        import boxinstseg_tpu_torch.ops.swin_attention
        from boxinstseg_tpu_torch.config import Config
        swin_l = Config.fromfile({SWIN_L!r})
        with torch.device('meta'):
            build_detector(swin_l.model)
        b2m['backbone'] = dict(type='SwinTransformer', embed_dims=16,
                               depths=(2, 2, 1, 1), num_heads=(2, 2, 2, 2),
                               window_size=4)
        b2m['panoptic_head']['in_channels'] = [16, 32, 64, 128]
        model = build_detector(b2m)
        opt = build_optimizer(dict(swin_l.optimizer),
                              model.named_parameters())
        step = make_train_step(model, opt, lambda i: 1e-4,
                               dict(max_norm=0.01))
        logs = step(batch, 0)
        assert all(torch.isfinite(v) for v in logs.values()), logs
        out = model.eval().predict(batch)
        assert out['masks_logit'].shape[:2] == out['scores'].shape

        # the DiscoBox teacher-student path: CRF, correspondence with the
        # bank (gates open, so appends and retrieval run), the EMA teacher
        from boxinstseg_tpu_torch.engine.train_state import TSTrainStep
        from boxinstseg_tpu_torch.ops.correspondence import \
            create_object_bank
        disco = {tiny_discobox_cfg()!r}
        model = build_detector(disco)
        opt = build_optimizer(dict(type='SGD', lr=0.01, momentum=0.9),
                              model.named_parameters())
        step = TSTrainStep(
            model, opt, lambda i: 0.01, start_iter=0,
            bank=create_object_bank(4, 8, (7, 7), (14, 14), 32))
        boxes = torch.tensor([[[8., 8., 40., 36.], [20., 24., 60., 60.]]] * 2)
        masks = torch.zeros(2, 2, 16, 16)
        masks[:, 0, 2:10, 2:11] = 1
        masks[:, 1, 6:16, 5:16] = 1
        batch = dict(image=torch.randn(2, 3, 64, 64, generator=g),
                     gt_bboxes=boxes, gt_masks=masks,
                     gt_labels=torch.tensor([[1, 2], [1, 3]]),
                     gt_valid=torch.ones(2, 2, dtype=torch.bool))
        for i in range(3):
            step.avg_loss_ins = torch.tensor(0.1)
            logs = step(batch, i)
            assert all(torch.isfinite(v) for v in logs.values()), logs
        assert 'loss_corr' in logs and step.teacher_forwards == 2
        assert int(step.bank.count.sum()) > 0

        # evaluation: DiscoBox, CondInst and Box2Mask predict, each output
        # family formatted, RLE-encoded and evaluated against RLE GT
        import numpy as np
        from boxinstseg_tpu_torch.apis.test import format_detection
        from boxinstseg_tpu_torch.core.eval import evaluate_coco
        from boxinstseg_tpu_torch.data.coco_api import COCO, rle_encode
        gt = np.zeros((64, 64), np.uint8)
        gt[8:36, 8:40] = 1
        coco = COCO(dataset=dict(
            images=[dict(id=1, height=64, width=64)],
            categories=[dict(id=c, name=str(c)) for c in range(1, 5)],
            annotations=[dict(id=1, image_id=1, category_id=2, iscrowd=0,
                              area=int(gt.sum()), bbox=[8, 8, 32, 28],
                              segmentation=rle_encode(gt))]))
        disco_out = model.eval().predict(dict(image=batch['image']))
        cond = build_detector({tiny_cfg(1)!r}).eval()
        cond.test_cfg = dict(score_thr=0.0)
        cond_out = cond.predict(dict(
            image=batch['image'], img_shape=torch.tensor([[64, 64]] * 2),
            scale_factor=torch.ones(2, 4)))
        b2m_out = build_detector(b2m).eval().predict(batch)
        for out in (disco_out, cond_out, b2m_out):
            det = format_detection(out, 0, (64, 64), (64, 64))
            assert len(det['masks']) == len(det['bboxes'])
            result = dict(bboxes=det['bboxes'], labels=det['labels'],
                          masks=[rle_encode(m) for m in det['masks']])
            stats = evaluate_coco(coco, [1], [1, 2, 3, 4], [result],
                                  ['bbox', 'segm'])
            assert 'segm_mAP' in stats, stats
        assert cond_out['valid'].any()
        perfect = dict(bboxes=np.array([[8., 8., 40., 36., 1.]]),
                       labels=np.array([1]), masks=[rle_encode(gt)])
        stats = evaluate_coco(coco, [1], [1, 2, 3, 4], [perfect],
                              ['bbox', 'segm'])
        assert stats['bbox_mAP'] == stats['segm_mAP'] == 1.0, stats

        bad = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]
        assert not bad and sys.modules['cv2'] is None, bad
        print('OK')
    ''')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith('OK')


class _TinyBoxDataset:
    """TrainLoader's dataset interface over seeded float images."""

    def __init__(self, n=4):
        self.flag = np.ones(n, np.uint8)
        self.n = n

    def __len__(self):
        return self.n

    def prepare(self, idx, rng, scale=None):
        img = rng.rand(64, 96, 3).astype(np.float32) * 4 - 2
        return dict(img=img, img_shape=img.shape, ori_shape=img.shape,
                    gt_bboxes=np.array([[8, 8, 50, 40], [30, 20, 90, 60]],
                                       np.float32),
                    gt_labels=np.array([1, 3]))


def test_train_detector_runs_and_saves_iter(tmp_path):
    from boxinstseg_tpu_torch.apis.train import train_detector
    from boxinstseg_tpu_torch.config import Config
    cfg = Config.fromdict(dict(
        model=tiny_cfg(1), data=dict(samples_per_gpu=2, workers_per_gpu=1),
        optimizer=dict(type='SGD', lr=0.01, momentum=0.9,
                       weight_decay=1e-4),
        lr_config=dict(policy='step', warmup='linear', warmup_iters=2,
                       warmup_ratio=0.1, step=[8]),
        runner=dict(type='IterBasedRunner', max_iters=3),
        canvases=[(64, 96)], max_gts=4, work_dir=str(tmp_path)))
    torch.manual_seed(0)
    model = build_detector(cfg.model)
    result = train_detector(model, _TinyBoxDataset(), cfg, device='cpu')
    assert result.step == 3 and len(result.history) == 3
    assert all(np.isfinite(v) for h in result.history for v in h.values())
    assert result.history[0]['lr'] == pytest.approx(0.001)
    ckpt = torch.load(result.checkpoint, map_location='cpu')
    assert ckpt['_iter'] == 3
    assert set(ckpt['state_dict']) == set(model.state_dict())
    log = (tmp_path / 'train.log').read_text()
    assert 'Iter [3/3]' in log and 'grad_norm' in log


def test_train_detector_applies_the_precision_key(tmp_path, caplog):
    """The shipped DiscoBox config asks for mixed precision (``fp16``),
    which the JAX package applies as bf16: so does the port, logging the
    policy once at start; the forward runs in bf16 and the parameters and
    losses stay fp32."""
    import logging
    from boxinstseg_tpu_torch.apis.train import train_detector
    from boxinstseg_tpu_torch.config import Config
    disco = Config.fromfile(os.path.join(
        ROOT, 'configs/discobox/discobox_solov2_coco_r50_fpn_3x.py'))
    assert disco.get('fp16') is not None
    cfg = Config.fromdict(dict(
        model=tiny_cfg(1), data=dict(samples_per_gpu=2, workers_per_gpu=1),
        optimizer=dict(type='SGD', lr=0.01, momentum=0.9),
        runner=dict(type='IterBasedRunner', max_iters=1),
        canvases=[(64, 96)], max_gts=4, work_dir=str(tmp_path),
        fp16=dict(disco.fp16)))
    torch.manual_seed(0)
    model = build_detector(cfg.model)
    seen = []
    model.backbone.conv1.register_forward_hook(
        lambda mod, args, out: seen.append(out.dtype))
    with caplog.at_level(logging.INFO, logger='boxinstseg_tpu_torch'):
        result = train_detector(model, _TinyBoxDataset(), cfg, device='cpu')
    said = [r.getMessage() for r in caplog.records
            if 'mixed precision' in r.getMessage()]
    assert said == ['mixed precision: bf16 activations, f32 params/losses']
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
    assert seen == [torch.bfloat16]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(np.isfinite(v) for h in result.history for v in h.values())


class _FailingBatcher:
    def __call__(self, samples):
        raise RuntimeError('batcher failed')


def test_loader_raises_a_producer_error_instead_of_hanging():
    import threading
    from boxinstseg_tpu_torch.data.loader import TrainLoader
    loader = TrainLoader(_TinyBoxDataset(), 2, _FailingBatcher(),
                         num_workers=1)
    got = []

    def consume():
        try:
            next(iter(loader))
        except RuntimeError as exc:
            got.append(exc)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), 'the consumer hangs on a dead producer'
    assert got and 'batcher failed' in str(got[0])
