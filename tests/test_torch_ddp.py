"""Data parallelism across processes (``boxinstseg_tpu_torch.parallel``) on
the CPU: two gloo ranks at batch 1 against one process at batch 2.

Each family (BoxInst, Box2Mask, BoxLevelset, DiscoBox), a tiny model from
one seed, trains 2 steps on one seeded global batch of 2 images that carry
1 and 6 GT boxes; rank r takes image r, the one process both:

- the mean over ranks of each step's logs equals the one process's logs
  (rtol 1e-5): the losses, and ``grad_norm``, the norm of the averaged
  gradient;
- every parameter and buffer after 2 steps (BN running statistics
  included) equals the one process's (atol 1e-5 / rtol 1e-4) on both
  ranks;
- DiscoBox, its gates held open so that the object bank is read and
  appended: the bank's ``ptr`` / ``count`` exactly and its contents at atol
  1e-6;
- each case is not vacuous: the same two ranks with local normalisers and
  local BN differ beyond those tolerances;
- BoxInst: the two ranks' losses and parameters also equal the JAX
  ``make_train_step`` at batch 2 (through ``params_from_jax``).

Every multi-process run gives ``init_process_group`` a 60 s timeout, joins
its children under its own limit and kills them on expiry, and picks a free
port. The children import this file, so JAX is imported only inside the
test that runs it.
"""
import contextlib
import os
import queue
import socket
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
from boxinstseg_tpu_torch.engine.schedules import build_lr_schedule
from boxinstseg_tpu_torch.engine.train_state import (TSTrainStep,
                                                     make_train_step)
from boxinstseg_tpu_torch.models.layers import SyncBatchNorm
from boxinstseg_tpu_torch.ops.correspondence import create_object_bank
from boxinstseg_tpu_torch.parallel import dist as pdist
from boxinstseg_tpu_torch.registry import build_detector

RUN_LIMIT = 150          # seconds a multi-process run may take in all
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
BANK_ATOL = 1e-6
GT_COUNTS = (1, 6)
G = 6


# ------------------------------------------------------------ the launcher

def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, results, args, env):
    try:
        torch.set_num_threads(1)
        if env:
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                              LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                              MASTER_PORT=str(port))
        else:
            pdist.init_distributed(backend='gloo',
                                   init_method=f'tcp://127.0.0.1:{port}',
                                   world_size=world, rank=rank,
                                   timeout=timedelta(seconds=60))
        results.put((rank, None, fn(*args)))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
    finally:
        pdist.destroy()


def run_ranks(fn, *args, world=2, limit=RUN_LIMIT, meanwhile=None,
              env=False):
    """``fn(*args)`` in ``world`` spawned gloo ranks, and ``meanwhile()``
    in this process while they run; returns (the ranks' results in rank
    order, meanwhile's). With ``env`` a child joins no group itself: it
    gets the environment of a ``torchrun`` launch instead. A child that
    raises, dies or outlasts ``limit`` fails the call; every child is gone
    when it returns."""
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, results, args, env),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit
    out, errors, extra = {}, [], None
    try:
        extra = meanwhile() if meanwhile is not None else None
        while len(out) + len(errors) < world:
            if time.monotonic() > deadline:
                errors.append(f'no result within {limit} s')
                break
            try:
                rank, err, res = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f'a rank died with exit code {dead}')
                    break
                continue
            if err is None:
                out[rank] = res
            else:
                errors.append(f'rank {rank}:\n{err}')
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not errors, '\n'.join(errors)
    return [out[r] for r in range(world)], extra


# ------------------------------------------------------------- the models

def boxinst_cfg():
    """The tiny CondInst of tests/test_torch_slice.py; its mask branch has
    BN."""
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
                       pairwise_warmup=1))


def box2mask_cfg():
    """The tiny Box2Mask of tests/test_box2mask_model.py with one encoder
    and two decoder layers, matching all 6 GTs."""
    return dict(
        type='Box2Mask',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=-1),
        panoptic_head=dict(
            type='Box2MaskHead', in_channels=[64, 128, 256, 512],
            strides=[4, 8, 16, 32], feat_channels=32, out_channels=32,
            num_things_classes=4, num_stuff_classes=0, num_queries=10,
            num_transformer_feat_level=3,
            pixel_decoder=dict(num_outs=3, num_encoder_layers=1),
            transformer_decoder=dict(num_layers=2, transformerlayers=dict(
                attn_cfgs=dict(num_heads=4), feedforward_channels=64)),
            loss_cls=dict(type='CrossEntropyLoss', loss_weight=2.0,
                          class_weight=[1.0] * 4 + [0.1]),
            loss_box=dict(type='BoxProjectionLoss', loss_weight=5.0),
            loss_mask=dict(type='LevelsetLoss', loss_weight=1.0),
            max_matched=G, tf_size=(16, 16), tf_max_depth=64),
        train_cfg=dict(
            assigner=dict(type='MaskHungarianAssigner',
                          cls_cost=dict(type='ClassificationCost',
                                        weight=2.0),
                          dice_cost=dict(type='BoxMatchingCost', weight=5.0,
                                         pred_act=True, eps=1.0)),
            sampler=dict(type='MaskPseudoSampler')),
        test_cfg=dict(panoptic_on=False, semantic_on=False,
                      instance_on=True, max_per_image=10))


def boxlevelset_cfg():
    """The tiny BoxLevelSet of tests/test_boxlevelset_model.py."""
    return dict(
        type='BoxLevelSet',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, start_level=0, num_outs=5),
        bbox_head=dict(
            type='BoxSOLOv2Head', num_classes=4, in_channels=32,
            seg_feat_channels=16, stacked_convs=1,
            strides=[8, 8, 16, 32, 32],
            scale_ranges=((1, 48), (24, 96), (48, 192), (96, 384),
                          (192, 2048)),
            sigma=0.2, num_grids=[12, 10, 8, 6, 4], cate_down_pos=0,
            loss_boxpro=dict(type='BoxProjectionLoss', loss_weight=3.0),
            max_pos=8, tf_size=(24, 24), tf_max_depth=64))


def discobox_cfg():
    """The tiny DiscoBox of tests/test_torch_discobox.py, with the
    correspondence loss and an object bank whose every same-class entry
    is retrieved (``seeded_bank`` fills it)."""
    return dict(
        type='DiscoBoxSOLOv2',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, start_level=0, num_outs=5),
        bbox_head=dict(
            type='DiscoBoxSOLOv2Head', num_classes=4, in_channels=32,
            seg_feat_channels=16, stacked_convs=1,
            strides=[8, 8, 16, 32, 32],
            scale_ranges=((1, 48), (24, 96), (48, 192), (96, 384),
                          (192, 2048)),
            sigma=0.2, num_grids=[12, 10, 8, 6, 4], ins_out_channels=16,
            loss_ins=dict(type='DiceLoss', use_sigmoid=True,
                          loss_weight=1.0),
            loss_ts=dict(type='DiceLoss', momentum=0.99,
                         use_ind_teacher=True, loss_weight=1.0, kernel=3,
                         max_iter=3, alpha0=2.0, theta0=0.5, theta1=30.0,
                         theta2=20.0, base=0.10),
            loss_cate=dict(type='FocalLoss', use_sigmoid=True, gamma=2.0,
                           alpha=0.25, loss_weight=1.0),
            max_pos=8, max_corr_queries=4,
            loss_corr=dict(
                type='InfoNCE', loss_weight=1.0, corr_exp=1.0,
                corr_eps=0.05, gaussian_filter_size=3, low_score=0.3,
                corr_num_iter=2, corr_num_smooth_iter=1, dist_kernel=5,
                obj_bank=dict(len_object_queues=8, fg_iou_thresh=0.0,
                              bg_iou_thresh=0.0, ratio_range=[0.0, 10.0],
                              appear_thresh=-1.0, max_retrieval_objs=5,
                              feat_height=7, feat_width=7, mask_height=14,
                              mask_width=14, min_size=2))),
        mask_feat_head=dict(type='DiscoBoxMaskFeatHead', in_channels=32,
                            out_channels=16, start_level=0, end_level=3,
                            num_classes=16,
                            norm_cfg=dict(type='GN', num_groups=8)))


# SGD for every family: the cases hold the averaged gradient; AdamW (the
# Box2Mask recipe's) divides each update by sqrt(v) + 1e-8, so an element
# whose gradient is at the float noise of the sums over ranks moves by up
# to the LR, which no parameter tolerance can tell from a fault
SGD = dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4)
# family: (config, image (h, w))
FAMILIES = {
    'boxinst': (boxinst_cfg, (128, 160)),
    'box2mask': (box2mask_cfg, (96, 96)),
    'boxlevelset': (boxlevelset_cfg, (128, 128)),
    'discobox': (discobox_cfg, (128, 128)),
}
LR = dict(policy='step', warmup='linear', warmup_iters=4, warmup_ratio=0.5,
          step=[8, 11])


def global_batch(family, seed=0):
    """The seeded global batch of 2 images with GT_COUNTS boxes: NCHW
    image, boxes, labels, validity and box bitmasks at stride 4."""
    h, w = FAMILIES[family][1]
    rng = np.random.RandomState(seed)
    b = len(GT_COUNTS)
    boxes = np.zeros((b, G, 4), np.float32)
    labels = np.zeros((b, G), np.int32)
    valid = np.zeros((b, G), bool)
    masks = np.zeros((b, G, h // 4, w // 4), np.uint8)
    for i, n in enumerate(GT_COUNTS):
        for g in range(n):
            x1, y1 = rng.randint(0, w - 48), rng.randint(0, h - 48)
            x2, y2 = x1 + rng.randint(20, 48), y1 + rng.randint(20, 48)
            boxes[i, g] = (x1, y1, x2, y2)
            labels[i, g] = rng.randint(0, 4)
            valid[i, g] = True
            masks[i, g, y1 // 4:y2 // 4 + 1, x1 // 4:x2 // 4 + 1] = 1
    image = rng.rand(b, 3, h, w).astype(np.float32) * 4 - 2
    return dict(image=image, img_shape=np.array([[h, w]] * b, np.int32),
                pixels_removed=np.array([5] * b, np.int32),
                scale_factor=np.ones((b, 4), np.float32),
                gt_bboxes=boxes, gt_labels=labels, gt_valid=valid,
                gt_masks=masks)


def seeded_bank():
    """A full object bank (8 entries of each of the 4 classes) from a
    seed, so that every query retrieves 5 entries from the first step."""
    rng = np.random.RandomState(7)
    bank = create_object_bank(4, 8, (7, 7), (14, 14), feat_dim=32)
    feat = np.maximum(rng.randn(4, 8, 7, 7, 32), 0)
    xy = rng.uniform(0, 60, (4, 8, 2))
    with torch.no_grad():
        bank.feat.copy_(torch.from_numpy(
            feat / np.linalg.norm(feat, axis=-1, keepdims=True)))
        bank.mask.copy_(torch.from_numpy(rng.rand(4, 8, 14, 14)))
        bank.box.copy_(torch.from_numpy(np.concatenate(
            [xy, xy + rng.uniform(20, 60, (4, 8, 2))], -1)))
        bank.count.fill_(8)
    return bank


def initial_state(family):
    """The family's initial weights from seed 0 (DiscoBox's mask kernels
    steepened, so that no mask pixel sits at a threshold)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_detector(FAMILIES[family][0]())
    if family == 'discobox':
        with torch.no_grad():
            model.bbox_head.solo_kernel.weight.mul_(30.0)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


# -------------------------------------------------- local normalisers

def _local_denominator(x, clamp_min=None, offset=0.0):
    total = x + offset if offset else x
    return torch.clamp(total, min=clamp_min) if clamp_min is not None \
        else total


def _local_bn(self, xf):
    with torch.no_grad():
        self._track(xf.mean(dim=(0, 2, 3)),
                    xf.var(dim=(0, 2, 3), unbiased=False))
    return F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0,
                        self.eps)


class local_statistics:
    """Within: every normaliser and every BN statistic of the rank's own
    slice (gradients are still averaged): what the global-batch semantics
    are held against."""

    def __enter__(self):
        self.saved = (pdist.reduce_mean_denominator,
                      SyncBatchNorm._global_forward)
        pdist.reduce_mean_denominator = _local_denominator
        SyncBatchNorm._global_forward = _local_bn

    def __exit__(self, *exc):
        pdist.reduce_mean_denominator, SyncBatchNorm._global_forward = \
            self.saved


# -------------------------------------------------------------- training

def train_family(family, state, steps=2, local=False):
    """``steps`` steps of ``family`` from ``state`` on this rank's slice of
    the global batch (all of it in one process). Returns the logs of each
    step (the mean over ranks), the final state dict and, for DiscoBox, the
    object bank, as numpy."""
    rank, world = pdist.rank(), pdist.world_size()
    cfg_fn, opt = FAMILIES[family][0], SGD
    model = build_detector(cfg_fn())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.train()
    pdist.broadcast_state(model)
    per = len(GT_COUNTS) // world
    batch = {k: torch.from_numpy(v[rank * per:(rank + 1) * per].copy())
             for k, v in global_batch(family).items()}
    optimizer = build_optimizer(opt, model.named_parameters())
    lr_fn = build_lr_schedule(LR, opt['lr'], 100, by_epoch=False)
    bank = None
    if family == 'discobox':
        bank = seeded_bank()
        step_fn = TSTrainStep(model, optimizer, lr_fn, momentum=0.9,
                              start_iter=0, bank=bank)
    else:
        step_fn = make_train_step(model, optimizer, lr_fn)
    logs = []
    with local_statistics() if local else contextlib.nullcontext():
        for i in range(steps):
            if bank is not None:
                step_fn.avg_loss_ins = torch.tensor(0.1)   # gates open
            out = pdist.mean_over_ranks(step_fn(batch, i))
            logs.append({k: float(v) for k, v in out.items()})
    result = dict(logs=logs, state={k: v.detach().numpy().copy()
                                    for k, v in model.state_dict().items()})
    if bank is not None:
        result['bank'] = {k: v.numpy().copy()
                          for k, v in bank._asdict().items()}
    return result


def two_rank_runs(family, state):
    """The global-statistics run, and the first step with local
    statistics, in the same two ranks."""
    return dict(glob=train_family(family, state),
                local=train_family(family, state, steps=1, local=True))


def assert_logs_match(got_logs, want_logs):
    for i, (got, want) in enumerate(zip(got_logs, want_logs)):
        assert set(got) == set(want)
        for k in want:
            if k == 'lr':
                continue
            assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL,
                                           abs=1e-7), (i, k)


def logs_match(got_logs, want_logs):
    return all(abs(g[k] - w[k]) <= LOSS_RTOL * abs(w[k]) + 1e-7
               for g, w in zip(got_logs, want_logs) for k in w if k != 'lr')


def default_threads_run(family, state):
    """The one process's run at torch's default thread count, as these
    cases were written: the DiscoBox one moves its weights by up to 12.5
    times PARAM_ATOL between 1 and 8 threads (another summation order),
    and holds the ranks within its tolerance at 8 (this host's default)
    but not at 1, 2 or 4."""
    with test_torch_threads.default_threads():
        return train_family(family, state)


@pytest.mark.parametrize('family', list(FAMILIES))
def test_two_ranks_equal_one_process_at_the_global_batch(family):
    state = initial_state(family)
    ranks, one = run_ranks(two_rank_runs, family, state,
                           meanwhile=lambda: default_threads_run(family,
                                                                 state))
    for r, runs in enumerate(ranks):
        got = runs['glob']
        assert_logs_match(got['logs'], one['logs'])
        for k, want in one['state'].items():
            if k.endswith('num_batches_tracked'):
                continue
            np.testing.assert_allclose(got['state'][k], want,
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f'rank {r}: {k}')
        if family == 'discobox':
            for k in ('ptr', 'count'):
                np.testing.assert_array_equal(got['bank'][k],
                                              one['bank'][k], err_msg=k)
            for k in ('feat', 'mask', 'box'):
                np.testing.assert_allclose(got['bank'][k], one['bank'][k],
                                           atol=BANK_ATOL, rtol=LOSS_RTOL,
                                           err_msg=k)
            assert one['bank']['count'].sum() > 4 * 8
            assert min(log['loss_corr'] for log in one['logs']) > 0
    # the ranks end with the same weights, bit for bit
    for k, v in ranks[0]['glob']['state'].items():
        np.testing.assert_array_equal(ranks[1]['glob']['state'][k], v,
                                      err_msg=k)
    # not vacuous: local normalisers and BN give another first step
    local = ranks[0]['local']
    assert not logs_match(local['logs'], one['logs'][:1])
    if family == 'boxinst':
        hold_against_jax(ranks[0]['glob'], state)


def hold_against_jax(got, state):
    """The two ranks' BoxInst run against the JAX ``make_train_step`` at
    batch 2 from the same weights (tests/test_torch_slice.py's harness)."""
    import jax
    import jax.numpy as jnp
    from boxinstseg_tpu.engine import (build_lr_schedule as j_schedule,
                                       build_optimizer as j_optimizer,
                                       create_train_state,
                                       make_train_step as j_train_step)
    from boxinstseg_tpu.registry import build_detector as j_build
    from boxinstseg_tpu.utils.checkpoint_convert import \
        convert_reference_checkpoint
    from boxinstseg_tpu_torch.utils.weights import params_from_jax

    params, stats = convert_reference_checkpoint(
        {k: torch.from_numpy(v) for k, v in state.items()})
    jm = j_build(boxinst_cfg())
    v = {'params': jax.tree_util.tree_map(jnp.asarray, params),
         'batch_stats': jax.tree_util.tree_map(jnp.asarray, stats)}
    tx = j_optimizer(SGD, j_schedule(LR, SGD['lr'], 100, by_epoch=False),
                     params_example=v['params'])
    train_state = create_train_state(jm, v, tx)
    j_step = j_train_step(jm, tx, donate=False)
    batch = global_batch('boxinst')
    batch['image'] = batch['image'].transpose(0, 2, 3, 1)
    jb = {k: jnp.asarray(x) for k, x in batch.items()
          if k not in ('gt_masks', 'scale_factor')}
    for i, want_logs in enumerate(got['logs']):
        train_state, logs = j_step(train_state, jb)
        for k, x in logs.items():
            assert want_logs[k] == pytest.approx(float(x), rel=1e-4,
                                                 abs=1e-6), (i, k)
    want = params_from_jax(
        jax.tree_util.tree_map(np.asarray, train_state.params),
        jax.tree_util.tree_map(np.asarray, train_state.batch_stats))
    for k, w in want.items():
        if k.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(got['state'][k], w.numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=k)
