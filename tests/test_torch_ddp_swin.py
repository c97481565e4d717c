"""Data parallelism across processes for the two models that
tests/test_torch_ddp.py does not hold: a small Box2Mask on a Swin backbone
(layer norms only, no BN to sync; the window attention's plain version on
the CPU) and a small fully supervised CondInst with its semantic head (the
dice and semantic denominators batch-wide, the semantic head's BN synced).

Two gloo ranks at batch 1 against one process at batch 2, 2 SGD steps on
one seeded global batch of 2 images with 1 and 6 GT boxes, with that
file's harness and tolerances: the mean over ranks of each step's logs
(rtol 1e-5), every parameter and buffer after the steps (atol 1e-5 / rtol
1e-4) on both ranks, the two ranks bit for bit alike, and the first step
with local normalisers and BN different. The children import this file,
which imports no JAX.
"""
import contextlib

import numpy as np
import pytest
import torch

from test_torch_ddp import (LR, PARAM_ATOL, PARAM_RTOL, SGD, assert_logs_match,
                            box2mask_cfg, boxinst_cfg, global_batch,
                            local_statistics, logs_match, run_ranks)

from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
from boxinstseg_tpu_torch.engine.schedules import build_lr_schedule
from boxinstseg_tpu_torch.engine.train_state import make_train_step
from boxinstseg_tpu_torch.parallel import dist as pdist
from boxinstseg_tpu_torch.registry import build_detector


def swin_box2mask_cfg():
    """tests/test_torch_ddp.py's Box2Mask on a tiny Swin (window 4; the
    last stage's 3x3 map shrinks it)."""
    cfg = box2mask_cfg()
    cfg['backbone'] = dict(type='SwinTransformer', embed_dims=16,
                           depths=(2, 2, 1, 1), num_heads=(2, 2, 2, 2),
                           window_size=4, out_indices=(0, 1, 2, 3))
    cfg['panoptic_head'] = dict(cfg['panoptic_head'],
                                in_channels=[16, 32, 64, 128])
    return cfg


def supervised_condinst_cfg():
    """tests/test_torch_ddp.py's CondInst, mask-supervised, with a semantic
    head (BN) on P3; 24 samples an image, so that the image with one box
    fills fewer of them than the one with six and the dice denominator
    differs from rank to rank."""
    cfg = boxinst_cfg()
    cfg['mask_head'] = dict(cfg['mask_head'], boxinst_enabled=False,
                            topk_per_img=24)
    cfg['segm_head'] = dict(type='CondInstSegmHead', num_classes=4,
                            in_channels=32, in_stride=8, stacked_convs=1,
                            feat_channels=16)
    return cfg


def condinst_batch():
    """The BoxInst global batch with stride-1 masks: each box filled."""
    batch = global_batch('boxinst')
    h, w = batch['image'].shape[2:]
    masks = np.zeros(batch['gt_masks'].shape[:2] + (h, w), np.uint8)
    for i, g in zip(*np.nonzero(batch['gt_valid'])):
        x1, y1, x2, y2 = batch['gt_bboxes'][i, g].astype(int)
        masks[i, g, y1 + 2:y2 - 1, x1 + 3:x2 - 2] = 1
    batch['gt_masks'] = masks
    return batch


CASES = {
    'swin box2mask': (swin_box2mask_cfg, lambda: global_batch('box2mask')),
    'supervised condinst': (supervised_condinst_cfg, condinst_batch),
}


def initial_state(case):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_detector(CASES[case][0]())
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def train_case(case, state, steps=2, local=False):
    """``steps`` SGD steps of ``case`` from ``state`` on this rank's slice
    of the global batch (all of it in one process): each step's logs (the
    mean over ranks) and the final state dict, as numpy."""
    rank, world = pdist.rank(), pdist.world_size()
    cfg_fn, batch_fn = CASES[case]
    model = build_detector(cfg_fn())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.train()
    pdist.broadcast_state(model)
    full = batch_fn()
    per = len(full['image']) // world
    batch = {k: torch.from_numpy(v[rank * per:(rank + 1) * per].copy())
             for k, v in full.items()}
    step_fn = make_train_step(
        model, build_optimizer(SGD, model.named_parameters()),
        build_lr_schedule(LR, SGD['lr'], 100, by_epoch=False))
    logs = []
    with local_statistics() if local else contextlib.nullcontext():
        for i in range(steps):
            out = pdist.mean_over_ranks(step_fn(batch, i))
            logs.append({k: float(v) for k, v in out.items()})
    return dict(logs=logs, state={k: v.detach().numpy().copy()
                                  for k, v in model.state_dict().items()})


def two_rank_runs(case, state):
    return dict(glob=train_case(case, state),
                local=train_case(case, state, steps=1, local=True))


@pytest.mark.parametrize('case', list(CASES))
def test_two_ranks_equal_one_process_at_the_global_batch(case):
    state = initial_state(case)
    ranks, one = run_ranks(two_rank_runs, case, state,
                           meanwhile=lambda: train_case(case, state))
    keys = {'supervised condinst': ('loss_mask', 'loss_segm'),
            'swin box2mask': ('d0.loss_levelset', 'loss_project')}[case]
    assert all(one['logs'][0][k] > 0 for k in keys), one['logs'][0]
    for r, runs in enumerate(ranks):
        assert_logs_match(runs['glob']['logs'], one['logs'])
        for k, want in one['state'].items():
            if k.endswith('num_batches_tracked'):
                continue
            np.testing.assert_allclose(runs['glob']['state'][k], want,
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f'rank {r}: {k}')
    for k, v in ranks[0]['glob']['state'].items():
        np.testing.assert_array_equal(ranks[1]['glob']['state'][k], v,
                                      err_msg=k)
    assert not logs_match(ranks[0]['local']['logs'], one['logs'][:1])
