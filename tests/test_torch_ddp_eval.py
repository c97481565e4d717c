"""Multi-process evaluation and launch of the PyTorch port, and the train
loop's ``auto_scale_lr`` and ``log_config.hooks`` keys, on the CPU:

- ``run_evaluation`` in 2 gloo ranks over 5 images (odd, so rank 1 pads
  its shard with a duplicate) returns the one-process metrics on rank 0 and
  ``{}`` on rank 1;
- ``TrainLoader`` in 2 ranks pads each rank's slice to the canvas and GT
  capacity of the global batch: each rank's batch is the one-process
  batch's slice, though the ranks' own images would pick another canvas and
  capacity;
- ``tools/train_torch.py --launcher pytorch --auto-scale-lr`` runs 2 ranks
  for 2 steps from JPEG files with polygon masks: one checkpoint, saved by
  rank 0 alone, the same weights on both ranks, and the LR of the JAX
  schedule at global batch 4;
- the base LR that ``auto_scale_lr`` and ``--auto-scale-lr`` give, and the
  LR at steps 0, 1 and 500, equal the JAX schedule's at world sizes 1 and
  2, with and without the flag;
- a ``log_config.hooks`` entry that the JAX package does not build (it
  builds ``TextLoggerHook`` and the wandb hooks) raises.

The children import this file, so JAX is imported only inside the tests
that use it.
"""
import json
import os
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

from boxinstseg_tpu_torch.apis import test as tapi
from boxinstseg_tpu_torch.apis.train import (TrainResult, build_hooks,
                                             resolve_intervals,
                                             train_schedule)
from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.data.batcher import StaticBatcher
from boxinstseg_tpu_torch.data.loader import TrainLoader
from boxinstseg_tpu_torch.parallel import dist as pdist
from boxinstseg_tpu_torch.registry import build_dataset, build_detector
from test_torch_ddp import boxinst_cfg, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOXINST = os.path.join(ROOT, 'configs/boxinst/boxinst_r50_fpn_1x_coco.py')
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
# the JAX schedule runs in float32: its warmup factor 1 - 0.999 (1 - i /
# 500) at step 0 is 1.3e-5 off in relative terms; the port's runs in float64
LR_RTOL = 1e-4
TEST_CFG = dict(nms_pre=200, score_thr=0.003,
                nms=dict(type='nms', iou_threshold=0.5), max_per_img=20,
                pre_nms_limit=300)


def load_tool(name):
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    import importlib
    return importlib.import_module(name)


# ------------------------------------------------------------ a data set

def write_dataset(root, n, seed=0, sizes=((64, 96), (80, 96))):
    """``n`` JPEGs of coloured blocks on noise (of ``sizes`` in turn) and a
    COCO json whose ground truth is polygons, 1 to 5 an image."""
    import cv2
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, 'images')
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        for _ in range(1 + i % 5):
            x, y = rng.randint(0, w - 32), rng.randint(0, h - 32)
            bw, bh = rng.randint(12, 32), rng.randint(12, 32)
            img[y:y + bh, x:x + bw] = rng.randint(0, 255, 3)
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1,
                category_id=int(rng.randint(1, 5)), iscrowd=0,
                area=float(bw * bh), bbox=[x, y, bw, bh],
                segmentation=[[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]))
        cv2.imwrite(os.path.join(img_dir, f'{i}.jpg'), img)
        images.append(dict(id=i + 1, width=w, height=h, file_name=f'{i}.jpg'))
    ann_file = os.path.join(root, 'ann.json')
    with open(ann_file, 'w') as f:
        json.dump(dict(images=images, annotations=anns, categories=[
            dict(id=c + 1, name=n) for c, n in enumerate('abcd')]), f)
    return ann_file, img_dir + '/'


def train_pipeline():
    """The shipped BoxInst train pipeline at a tiny scale."""
    return [dict(type='LoadImageFromFile'),
            dict(type='LoadAnnotations', with_bbox=True, with_mask=False),
            dict(type='Resize', img_scale=[(96, 64), (96, 56)],
                 multiscale_mode='value', keep_ratio=True),
            dict(type='RandomFlip', flip_ratio=0.5),
            dict(type='Normalize', **NORM),
            dict(type='Pad', size_divisor=32),
            dict(type='DefaultFormatBundle'),
            dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'])]


def eval_pipeline():
    return [dict(type='LoadImageFromFile'),
            dict(type='MultiScaleFlipAug', img_scale=(96, 80), flip=False,
                 transforms=[dict(type='Resize', keep_ratio=True),
                             dict(type='RandomFlip'),
                             dict(type='Normalize', **NORM),
                             dict(type='Pad', size_divisor=32),
                             dict(type='ImageToTensor', keys=['img']),
                             dict(type='Collect', keys=['img'])])]


def cfg_dict(ann_file, img_dir, max_iters=2):
    model = boxinst_cfg()
    model['test_cfg'] = TEST_CFG
    data = dict(type='CocoDataset', ann_file=ann_file, img_prefix=img_dir,
                classes=('a', 'b', 'c', 'd'))
    return dict(
        model=model, canvases=[(64, 96), (96, 96)], max_gts=8,
        gt_buckets=[2, 4], seed=0,
        data=dict(samples_per_gpu=1, workers_per_gpu=1,
                  train=dict(data, pipeline=train_pipeline()),
                  test=dict(data, pipeline=eval_pipeline())),
        optimizer=dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4),
        lr_config=dict(policy='step', warmup='linear', warmup_iters=500,
                       warmup_ratio=0.001, step=[8, 11]),
        runner=dict(type='IterBasedRunner', max_iters=max_iters),
        checkpoint_config=dict(interval=max_iters, by_epoch=False),
        log_config=dict(interval=1, hooks=[dict(type='TextLoggerHook')]))


# ------------------------------------------------------------ evaluation

def evaluate(cfg_d, state, save_results=None):
    """``run_evaluation`` of the tiny CondInst with ``state`` on this
    rank's share of the test set."""
    cfg = Config.fromdict(cfg_d)
    model = build_detector(cfg.model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    return tapi.run_evaluation(model, dataset, cfg, metrics=['bbox', 'segm'],
                               save_results=save_results)


def test_distributed_evaluation_returns_the_one_process_metrics(tmp_path):
    """The ground truth is each image's own first detections, so a result
    gathered under another image would lower the metrics. The images are of
    one size: a batch is padded to the canvas its largest image picks, and
    the padding moves the detections near it, so batches of other images
    (a shard's) would give other results in one process too."""
    from boxinstseg_tpu_torch.data.coco_api import rle_decode
    ann_file, img_dir = write_dataset(str(tmp_path), 5, sizes=((64, 96),))
    cfg_d = cfg_dict(ann_file, img_dir)
    cfg_d['data']['samples_per_gpu'] = 2
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_detector(cfg_d['model'])
    with torch.no_grad():        # boxes of 4 strides around each point
        model.bbox_head.conv_reg.weight.zero_()
        model.bbox_head.conv_reg.bias.fill_(2.0)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    dets_file = str(tmp_path / 'dets.json')
    evaluate(cfg_d, state, save_results=dets_file)
    with open(ann_file) as f:
        coco = json.load(f)
    with open(dets_file) as f:
        dets = json.load(f)
    coco['annotations'] = []
    for img, r in zip(coco['images'], dets):
        for box, label, rle in list(zip(r['bboxes'], r['labels'],
                                        r['masks']))[:3]:
            x1, y1, x2, y2, _ = box
            area = float(rle_decode(rle).sum())
            if x2 - x1 >= 2 and y2 - y1 >= 2 and area >= 4:
                coco['annotations'].append(dict(
                    id=len(coco['annotations']) + 1, image_id=img['id'],
                    category_id=label + 1, iscrowd=0, area=area,
                    bbox=[x1, y1, x2 - x1, y2 - y1], segmentation=rle))
    assert len(coco["annotations"]) >= 5
    with open(ann_file, 'w') as f:
        json.dump(coco, f)

    ranks, one = run_ranks(evaluate, cfg_d, state,
                           meanwhile=lambda: evaluate(cfg_d, state))
    assert ranks[1] == {}
    assert ranks[0] == one
    assert one['bbox_mAP'] > 0.3 and one['segm_mAP'] > 0.3
    assert tapi.shard_indices(5, 1, 2) == [1, 3, 3]


# ------------------------------------------------------------ the loader

class _SizedDataset:
    """TrainLoader's dataset interface: image i is 64x96 with 1 GT when i
    is even and 80x96 with 3 GTs when odd."""
    flag = np.ones(4, np.uint8)

    def __len__(self):
        return 4

    def prepare(self, idx, rng, scale=None):
        h, n = (64, 1) if idx % 2 == 0 else (80, 3)
        img = np.full((h, 96, 3), idx, np.float32)
        boxes = np.tile(np.array([[4, 4, 40, 30]], np.float32), (n, 1))
        return dict(img=img, img_shape=img.shape, ori_shape=img.shape,
                    gt_bboxes=boxes, gt_labels=np.arange(n))


def load_batches(n_batches=3):
    batcher = StaticBatcher(canvases=[(64, 96), (96, 96)], max_gts=8,
                            gt_buckets=[2, 4])
    loader = TrainLoader(_SizedDataset(), 2, batcher, num_workers=1,
                         process_id=pdist.rank(),
                         process_count=pdist.world_size(),
                         extent_max=pdist.max_reducer())
    batches = iter(loader)
    try:
        return [next(batches) for _ in range(n_batches)]
    finally:
        batches.close()


def test_ranks_pad_their_slice_as_the_global_batch():
    ranks, one = run_ranks(load_batches, meanwhile=load_batches)
    mixed = 0
    for step, whole in enumerate(one):
        firsts = [int(whole['image'][i, 0, 0, 0]) for i in range(2)]
        mixed += len({f % 2 for f in firsts}) == 2
        for r, batches in enumerate(ranks):
            for k, v in whole.items():
                np.testing.assert_array_equal(batches[step][k], v[r:r + 1],
                                              err_msg=f'{step} {r} {k}')
    assert mixed                  # a batch whose ranks differ on their own


# ------------------------------------------------------------ the launcher

def run_train_tool(argv):
    """``tools/train_torch.py``'s ``main`` as one rank that it launches
    itself (``--launcher pytorch``, the group's timeout held to 60 s);
    returns its logs, the checkpoint path, how many files it saved and its
    final weights."""
    import functools
    tool = load_tool('train_torch')
    pdist.init_distributed = functools.partial(
        pdist.init_distributed, timeout=timedelta(seconds=60))
    saved, save = [], torch.save

    def counted(obj, path, *a, **k):
        saved.append(str(path))
        return save(obj, path, *a, **k)
    torch.save = counted
    try:
        result = tool.main(argv)
        model_state = torch.load(result.checkpoint, map_location='cpu',
                                 weights_only=False)['state_dict']
    finally:
        torch.save = save
    return dict(history=result.history, checkpoint=result.checkpoint,
                saved=saved, state={k: v.numpy() for k, v in
                                    model_state.items()})


def test_train_tool_launches_two_ranks_from_image_files(tmp_path):
    ann_file, img_dir = write_dataset(str(tmp_path), 4)
    cfg_file = tmp_path / 'cfg.py'
    cfg_file.write_text('\n'.join(
        f'{k} = {v!r}' for k, v in cfg_dict(ann_file, img_dir).items()))
    work_dir = tmp_path / 'wd'
    argv = [str(cfg_file), '--work-dir', str(work_dir), '--device', 'cpu',
            '--launcher', 'pytorch', '--auto-scale-lr', '--no-validate']
    ranks, _ = run_ranks(run_train_tool, argv, env=True)
    assert [len(r['saved']) for r in ranks] == [1, 0]
    assert sorted(os.listdir(work_dir)) == ['iter_2.pth', 'train.log']
    assert ranks[0]['checkpoint'] == ranks[1]['checkpoint'] \
        == str(work_dir / 'iter_2.pth')
    log = (work_dir / 'train.log').read_text()
    assert log.count('checkpoint saved') == 1
    assert 'rank 0 of 2, global batch 2' in log
    assert ranks[1]['history'] == []
    history = ranks[0]['history']
    assert len(history) == 2
    assert all(np.isfinite(v) for h in history for v in h.values())
    # auto_scale_lr: 0.01 x global batch 2 / 16, the JAX schedule's LR
    from boxinstseg_tpu.engine import build_lr_schedule as j_schedule
    j_lr = j_schedule(cfg_dict(ann_file, img_dir)['lr_config'],
                      0.01 * 2 / 16, 2)
    for i, h in enumerate(history):
        assert h['lr'] == pytest.approx(float(j_lr(i)), rel=LR_RTOL)
    for k, v in ranks[0]['state'].items():
        np.testing.assert_array_equal(ranks[1]['state'][k], v, err_msg=k)


# ------------------------------------------------------ auto_scale_lr (F7)


@pytest.mark.parametrize('world', [1, 2])
@pytest.mark.parametrize('flag', [False, True])
@pytest.mark.parametrize('base', [None, 8])
def test_auto_scale_lr_gives_the_jax_schedule(world, flag, base):
    """The shipped BoxInst config through ``tools/train_torch.py``'s config
    handling (``auto_scale_lr`` absent, or present with base_batch_size 8
    and enable False) against ``tools/train.py``'s and the JAX
    ``train_detector``'s rule, over COCO's 118287 images at
    samples_per_gpu 2."""
    from boxinstseg_tpu.config import Config as JConfig
    from boxinstseg_tpu.engine import build_lr_schedule as j_schedule
    tool = load_tool('train_torch')
    opts = [] if base is None else [f'auto_scale_lr.base_batch_size={base}',
                                    'auto_scale_lr.enable=False']
    cfg = tool.load_config(BOXINST, opts, auto_scale_lr=flag)
    global_batch = 2 * world
    lr_fn, base_lr, ipe, iv = train_schedule(cfg, global_batch, 118287)

    jcfg = JConfig.fromfile(BOXINST)
    jcfg.merge_from_dict(dict(kv.split('=', 1) for kv in opts))
    if flag:                                 # tools/train.py:77-81
        if 'auto_scale_lr' in jcfg:
            jcfg.auto_scale_lr['enable'] = True
        else:
            jcfg.auto_scale_lr = dict(enable=True, base_batch_size=16)
    want = jcfg.optimizer['lr']              # apis/train.py:208-210
    if jcfg.get('auto_scale_lr', {}).get('enable', False):
        want = want * global_batch / jcfg['auto_scale_lr'].get(
            'base_batch_size', 16)
    assert base_lr == pytest.approx(want, rel=1e-12)
    assert (base_lr != cfg.optimizer['lr']) == flag
    assert ipe == 118287 // global_batch
    j_lr = j_schedule(jcfg['lr_config'], want, ipe,
                      by_epoch=iv['lr_by_epoch'], max_iters=iv['max_iters'])
    for step in (0, 1, 500):
        assert lr_fn(step) == pytest.approx(float(j_lr(step)), rel=LR_RTOL)


# ------------------------------------------------------ log_config.hooks

@pytest.mark.parametrize('hook', ['TensorboardLoggerHook', 'PaviLoggerHook',
                                  'MlflowLoggerHook'])
def test_a_log_hook_the_port_lacks_raises(tmp_path, hook):
    cfg = Config.fromdict(dict(
        model=boxinst_cfg(), runner=dict(type='IterBasedRunner',
                                         max_iters=2),
        log_config=dict(interval=1, hooks=[dict(type='TextLoggerHook'),
                                           dict(type=hook)])))
    iv = resolve_intervals(cfg, 1)
    with pytest.raises(NotImplementedError, match=hook):
        build_hooks(cfg, iv, str(tmp_path), None, TrainResult(step=0))
