"""The port's train loop honours the runtime config, as the JAX package's.

- ``resolve_intervals`` against the JAX function on every shipped config
  (pure Python: both read the same ``Config``);
- the steps ``CheckpointHook`` saves and keeps, and those ``EvalHook``
  evaluates at (with ``dynamic_intervals``), against the JAX hooks;
- ``train_detector`` on a tiny BoxInst on the CPU: periodic saves with
  ``max_keep_ckpts``, ``save_last``, a resume from a checkpoint (model,
  optimizer and ``_iter`` restored, the schedule going on from there),
  ``auto_resume``, and ``log_config.interval`` (one log line and one
  history entry every n steps);
- ``tools/train_torch.py --pretrained-backbone`` loads a torchvision-format
  ResNet file that the test writes;
- ``tools/train_torch.py`` with a ``data.val`` set evaluates it in the
  middle of the run, and training goes on as it would without it.
"""
import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.apis.train import resolve_intervals as j_resolve
from boxinstseg_tpu.engine import hooks as jhooks
from test_torch_slice import ROOT, _TinyBoxDataset, tiny_cfg

from boxinstseg_tpu_torch.apis import train as tt
from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.engine import hooks as thooks
from boxinstseg_tpu_torch.registry import DATASETS, build_detector

SHIPPED = sorted(p for p in glob.glob(os.path.join(ROOT, 'configs', '**',
                                                   '*.py'), recursive=True)
                 if '_base_' not in p)


@pytest.mark.parametrize('path', SHIPPED,
                         ids=[os.path.relpath(p, ROOT) for p in SHIPPED])
def test_resolve_intervals_matches_jax_on_shipped_configs(path):
    cfg = Config.fromfile(path)
    for iters_per_epoch in (1, 7330):
        assert tt.resolve_intervals(cfg, iters_per_epoch) == j_resolve(
            cfg, iters_per_epoch)


class _Saved:
    def checkpoint(self, step, meta=None):
        return {'_iter': step}


@pytest.mark.parametrize('interval,max_keep,save_last,max_iters', [
    (2, 1, True, 5), (3, 2, True, 10), (4, 3, False, 10), (5, 3, True, 10),
    (1, 100, False, 4)])
def test_checkpoint_hook_saves_and_keeps_as_jax(
        tmp_path, monkeypatch, interval, max_keep, save_last, max_iters):
    saved = []
    monkeypatch.setattr(
        'boxinstseg_tpu.engine.checkpoints.save_checkpoint',
        lambda d, state, step, max_to_keep=3, meta=None: saved.append(step))
    jhook = jhooks.CheckpointHook(str(tmp_path / 'jax'), interval, max_keep,
                                  save_last, max_iters)
    thook = thooks.CheckpointHook(str(tmp_path), interval, max_keep,
                                  save_last, max_iters)
    for i in range(max_iters):
        jhook.after_step(i, None, {})
        thook.after_step(i, _Saved(), {})
    assert saved                              # orbax keeps the newest
    assert thooks.checkpoint_steps(str(tmp_path)) == saved[-max_keep:]
    assert thook.last == str(tmp_path / f'iter_{saved[-1]}.pth')
    assert torch.load(thook.last)['_iter'] == saved[-1]


@pytest.mark.parametrize('found,start,keep,want', [
    ([10], 0, 1, [4, 10]),            # a fresh run beside another run's file
    ([2, 4, 6], 4, 2, [6, 8])])       # a resumed run prunes its own older
def test_checkpoint_hook_prunes_only_the_runs_own_files(tmp_path, found,
                                                        start, keep, want):
    for n in found:
        torch.save({'_iter': n, 'old': True}, tmp_path / f'iter_{n}.pth')
    hook = thooks.CheckpointHook(str(tmp_path), 2, keep, True, start + 4,
                                 start=start)
    for i in range(start, start + 4):
        hook.after_step(i, _Saved(), {})
    assert thooks.checkpoint_steps(str(tmp_path)) == want
    assert hook.last == str(tmp_path / f'iter_{start + 4}.pth')
    assert 'old' not in torch.load(hook.last)


def test_eval_hook_steps_match_jax(monkeypatch):
    dynamic = [(4, 1), (8, 3)]
    seen = {'jax': [], 'port': []}

    class State:
        model = None

        def variables(self):
            return None

    def record(pkg):
        return lambda model, variables_or_dataset, *a, **k: seen[pkg].append(
            len(seen[pkg])) or {}
    monkeypatch.setattr('boxinstseg_tpu.apis.test.run_evaluation',
                        record('jax'))
    monkeypatch.setattr('boxinstseg_tpu_torch.apis.test.run_evaluation',
                        record('port'))
    jhook = jhooks.EvalHook(None, None, None, 2, dynamic_intervals=dynamic)
    thook = thooks.EvalHook(None, None, 2, dynamic_intervals=dynamic)
    steps = {'jax': [], 'port': []}
    for i in range(14):
        for pkg, hook in (('jax', jhook), ('port', thook)):
            n = len(seen[pkg])
            hook.after_step(i, State(), {})
            if len(seen[pkg]) > n:
                steps[pkg].append(i + 1)
    assert steps['port'] == steps['jax'] == [2, 4, 5, 6, 7, 9, 12]


def run(tmp_path, max_iters, log_interval=1, resume_from=None, **cfg_kw):
    """``train_detector`` on the tiny BoxInst of tests/test_torch_slice.py,
    checkpoints every 2 steps."""
    cfg = Config.fromdict(dict(
        model=tiny_cfg(1), data=dict(samples_per_gpu=2, workers_per_gpu=1),
        optimizer=dict(type='SGD', lr=0.01, momentum=0.9,
                       weight_decay=1e-4),
        lr_config=dict(policy='step', warmup='linear', warmup_iters=3,
                       warmup_ratio=0.1, step=[8]),
        runner=dict(type='IterBasedRunner', max_iters=max_iters),
        checkpoint_config=dict(interval=2, by_epoch=False,
                               max_keep_ckpts=cfg_kw.pop('max_keep', 1)),
        log_config=dict(interval=log_interval), canvases=[(64, 96)],
        max_gts=4, work_dir=str(tmp_path), **cfg_kw))
    torch.manual_seed(0)
    model = build_detector(cfg.model)
    return model, tt.train_detector(model, _TinyBoxDataset(), cfg,
                                    device='cpu', resume_from=resume_from)


def test_train_detector_saves_periodically_and_keeps_the_newest(tmp_path):
    _, result = run(tmp_path, 4)
    assert result.step == 4 and len(result.history) == 4
    assert sorted(os.listdir(tmp_path)) == ['iter_4.pth', 'train.log']
    assert result.checkpoint == str(tmp_path / 'iter_4.pth')
    assert torch.load(result.checkpoint, weights_only=False)['_iter'] == 4


def test_save_last_saves_at_max_iters_off_the_interval(tmp_path):
    _, result = run(tmp_path, 3, max_keep=3)
    assert thooks.checkpoint_steps(str(tmp_path)) == [2, 3]
    assert result.checkpoint == str(tmp_path / 'iter_3.pth')


def test_resume_restores_the_run_and_goes_on_from_its_iter(tmp_path):
    first, two = run(tmp_path / 'a', 2)
    ckpt = torch.load(two.checkpoint, weights_only=False)
    assert ckpt['_iter'] == 2
    # nothing left to run: the model and optimizer are the checkpoint's
    model, idle = run(tmp_path / 'b', 2, resume_from=two.checkpoint)
    assert idle.step == 2 and idle.history == [] and idle.checkpoint is None
    for k, v in ckpt['state_dict'].items():
        assert torch.equal(model.state_dict()[k], v), k
    _, full = run(tmp_path / 'c', 4)
    _, resumed = run(tmp_path / 'd', 4, resume_from=two.checkpoint)
    assert resumed.step == 4 and len(resumed.history) == 2
    # the schedule goes on from step 3: the warmup's LRs of steps 3 and 4
    assert [h['lr'] for h in resumed.history] == pytest.approx(
        [h['lr'] for h in full.history[2:]])
    log = (tmp_path / 'd' / 'train.log').read_text()
    assert 'Iter [3/4]' in log and 'Iter [1/4]' not in log
    assert torch.load(resumed.checkpoint, weights_only=False)['_iter'] == 4
    # SGD's momentum buffers came back with the optimizer
    assert all('momentum_buffer' in s for s in ckpt['optimizer']['state']
               .values())


def test_auto_resume_takes_the_newest_checkpoint(tmp_path):
    run(tmp_path, 4, max_keep=2)
    assert thooks.checkpoint_steps(str(tmp_path)) == [2, 4]
    assert thooks.latest_checkpoint(str(tmp_path)) == str(
        tmp_path / 'iter_4.pth')
    _, result = run(tmp_path, 5, max_keep=2, auto_resume=True)
    assert result.step == 5 and len(result.history) == 1
    assert thooks.checkpoint_steps(str(tmp_path)) == [4, 5]
    assert 'resumed from' in (tmp_path / 'train.log').read_text()


def test_log_interval_reads_the_losses_every_n_steps(tmp_path):
    _, result = run(tmp_path, 4, log_interval=2)
    assert result.step == 4 and len(result.history) == 2
    assert all(np.isfinite(v) for h in result.history for v in h.values())
    log = (tmp_path / 'train.log').read_text()
    assert 'Iter [2/4]' in log and 'Iter [4/4]' in log
    assert 'Iter [1/4]' not in log and 'Iter [3/4]' not in log


def load_train_tool():
    spec = importlib.util.spec_from_file_location(
        'train_torch_tool', os.path.join(ROOT, 'tools', 'train_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pretrained_backbone_loads_a_torchvision_file(tmp_path):
    cfg = dict(model=tiny_cfg(1),
               data=dict(samples_per_gpu=2, workers_per_gpu=1,
                         train=dict(type='_TinyBoxDataset')),
               optimizer=dict(type='SGD', lr=0.0, momentum=0.9),
               runner=dict(type='IterBasedRunner', max_iters=1),
               canvases=[(64, 96)], max_gts=4)
    cfg_file = tmp_path / 'cfg.py'
    cfg_file.write_text('\n'.join(f'{k} = {v!r}' for k, v in cfg.items()))
    if '_TinyBoxDataset' not in DATASETS:
        DATASETS.register_module(module=_TinyBoxDataset)
    torch.manual_seed(1)
    backbone = build_detector(cfg['model']).backbone.state_dict()
    gen = torch.Generator().manual_seed(2)
    file = {k: 0.5 + torch.rand(v.shape, generator=gen)
            if k.endswith('running_var')
            else 0.05 * torch.randn(v.shape, generator=gen)
            for k, v in backbone.items()}
    file.update({'fc.weight': torch.zeros(1000, 512),
                 'fc.bias': torch.zeros(1000),
                 'bn1.num_batches_tracked': torch.tensor(0)})
    torch.save(file, tmp_path / 'resnet18.pth')
    mod = load_train_tool()
    result = mod.main([str(cfg_file), '--work-dir', str(tmp_path / 'wd'),
                       '--device', 'cpu', '--no-validate',
                       '--pretrained-backbone',
                       str(tmp_path / 'resnet18.pth')])
    sd = torch.load(result.checkpoint, weights_only=False)['state_dict']
    for k, v in backbone.items():
        assert torch.equal(sd[f'backbone.{k}'], file[k]), k
    torch.save({'state_dict': {'conv1.weight': file['conv1.weight']}},
               tmp_path / 'partial.pth')
    with pytest.raises(KeyError, match='missing'):
        mod.main([str(cfg_file), '--work-dir', str(tmp_path / 'wd2'),
                  '--device', 'cpu', '--pretrained-backbone',
                  str(tmp_path / 'partial.pth')])


def test_resume_restores_the_teacher_student_state(tmp_path):
    """A DiscoBox checkpoint brings back the teacher, the object bank and
    ``avg_loss_ins`` with the student and its optimizer (the bank and the
    average set to values a short run would not reach)."""
    import copy
    from test_torch_discobox import _TinyMaskDataset, corr_cfg

    def ts_run(work_dir, max_iters, resume_from=None):
        cfg = Config.fromdict(dict(
            model=dict(corr_cfg(), type='DiscoBoxSOLOv2'),
            data=dict(samples_per_gpu=2, workers_per_gpu=1),
            optimizer=dict(type='SGD', lr=0.01, momentum=0.9),
            lr_config=dict(policy='fixed'),
            runner=dict(type='IterBasedRunner', max_iters=max_iters),
            ts_cfg=dict(momentum=0.9, start_iter=0), with_gt_masks=True,
            canvases=[(128, 128)], max_gts=4, work_dir=str(work_dir)))
        torch.manual_seed(0)
        model = build_detector(copy.deepcopy(cfg.model))
        return model, tt.train_detector(model, _TinyMaskDataset(), cfg,
                                        device='cpu',
                                        resume_from=resume_from)

    _, one = ts_run(tmp_path / 'a', 1)
    ckpt = torch.load(one.checkpoint, weights_only=False)
    gen = torch.Generator().manual_seed(0)
    ckpt['object_bank'] = {k: (torch.randn(v.shape, generator=gen)
                               if v.is_floating_point()
                               else torch.randint(1, 5, v.shape,
                                                  generator=gen).int())
                           for k, v in ckpt['object_bank'].items()}
    ckpt['avg_loss_ins'] = torch.tensor(0.125)
    torch.save(ckpt, tmp_path / 'edited.pth')
    states = []
    step_cls = tt.TSTrainStep

    class Capture(step_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            states.append(self)
    tt.TSTrainStep = Capture
    try:
        model, idle = ts_run(tmp_path / 'b', 1,
                             resume_from=str(tmp_path / 'edited.pth'))
    finally:
        tt.TSTrainStep = step_cls
    assert idle.step == 1 and not idle.history
    restored = states[0]
    for k, v in ckpt['teacher_state_dict'].items():
        assert torch.equal(restored.teacher.state_dict()[k], v), k
    for k, v in ckpt['state_dict'].items():
        assert torch.equal(model.state_dict()[k], v), k
    for name, v in ckpt['object_bank'].items():
        assert torch.equal(getattr(restored.bank, name), v), name
    assert restored.avg_loss_ins.item() == 0.125


def test_train_tool_evaluates_the_val_set_during_training(tmp_path):
    """``data.val`` is built in test mode and evaluated after steps 2 and 4
    (``evaluation.interval=2`` under an IterBasedRunner); each evaluation
    returns finite metrics, and the losses are those of the same run with
    ``--no-validate``: the switch to predict and back leaves training as it
    was."""
    import cv2
    from boxinstseg_tpu_torch.data.coco_api import rle_encode
    rng = np.random.RandomState(3)
    img_dir = tmp_path / 'images'
    img_dir.mkdir()
    images, anns = [], []
    for i in range(2):
        cv2.imwrite(str(img_dir / f'{i}.png'),
                    rng.randint(0, 255, (64, 96, 3)).astype(np.uint8))
        images.append(dict(id=i + 1, width=96, height=64,
                           file_name=f'{i}.png'))
        for x1, y1, x2, y2 in ((8, 8, 50, 40), (30, 20, 90, 60)):
            mask = np.zeros((64, 96), np.uint8)
            mask[y1:y2, x1:x2] = 1
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=len(anns) % 4 + 1, iscrowd=0,
                             area=float(mask.sum()),
                             bbox=[x1, y1, x2 - x1, y2 - y1],
                             segmentation=rle_encode(mask)))
    (tmp_path / 'ann.json').write_text(json.dumps(dict(
        images=images, annotations=anns,
        categories=[dict(id=c + 1, name=n) for c, n in enumerate('abcd')])))
    pipeline = [dict(type='LoadImageFromFile'),
                dict(type='MultiScaleFlipAug', img_scale=(96, 64),
                     flip=False, transforms=[
                         dict(type='Resize', keep_ratio=True),
                         dict(type='RandomFlip'),
                         dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                              std=[58.395, 57.12, 57.375], to_rgb=True),
                         dict(type='Pad', size_divisor=32),
                         dict(type='ImageToTensor', keys=['img']),
                         dict(type='Collect', keys=['img'])])]
    model = tiny_cfg(1)
    model['test_cfg'] = dict(nms_pre=50, score_thr=0.003,
                             nms=dict(type='nms', iou_threshold=0.5),
                             max_per_img=10)
    cfg = dict(model=model,
               data=dict(samples_per_gpu=2, workers_per_gpu=1,
                         train=dict(type='_TinyBoxDataset'),
                         val=dict(type='CocoDataset',
                                  ann_file=str(tmp_path / 'ann.json'),
                                  img_prefix=str(img_dir) + '/',
                                  classes=('a', 'b', 'c', 'd'),
                                  pipeline=pipeline)),
               optimizer=dict(type='SGD', lr=0.01, momentum=0.9),
               runner=dict(type='IterBasedRunner', max_iters=4),
               evaluation=dict(interval=2, metric=['bbox', 'segm']),
               canvases=[(64, 96)], max_gts=4)
    cfg_file = tmp_path / 'cfg.py'
    cfg_file.write_text('\n'.join(f'{k} = {v!r}' for k, v in cfg.items()))
    if '_TinyBoxDataset' not in DATASETS:
        DATASETS.register_module(module=_TinyBoxDataset)
    tool = load_train_tool()
    runs = {flag: tool.main([str(cfg_file), '--work-dir',
                             str(tmp_path / f'wd{len(flag)}'), '--device',
                             'cpu', *flag])
            for flag in ((), ('--no-validate',))}
    validated, plain = runs[()], runs[('--no-validate',)]
    assert [n for n, _ in validated.evaluations] == [2, 4]
    assert plain.evaluations == []
    for _, metrics in validated.evaluations:
        assert {'bbox_mAP', 'segm_mAP'} <= set(metrics)
        assert all(np.isfinite(v) for v in metrics.values())
    assert len(validated.history) == len(plain.history) == 4
    for got, want in zip(validated.history, plain.history):
        assert {k: v for k, v in got.items() if 'time' not in k} == \
            {k: v for k, v in want.items() if 'time' not in k}
