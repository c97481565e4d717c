"""The port's analysis, benchmark and misc tools against the JAX package's,
on the CPU, with the evaluation set of ``tests/test_torch_eval.py`` (a
tiny CondInst whose top detections are the ground truth of four images).

- ``get_flops_torch``: the parameter count of the tiny BoxInst and the
  tiny Box2Mask equals the JAX package's (every leaf of ``params``), and
  the FLOPs hold the MSDA op's formula for Box2Mask;
- ``benchmark_torch --device cpu``: predict and ``--train`` on a tiny
  config, a median between the min and the max;
- ``eval_metric_torch``, ``analyze_results_torch``,
  ``confusion_matrix_torch`` and ``coco_error_analysis_torch`` on one
  ``--save-results`` json: the JAX tools' outputs (metrics exactly, the
  per-image scores and drawn files byte for byte, the matrix exactly, the
  analysis summary exactly);
- ``test_robustness_torch``: every corruption at every severity byte for
  byte the JAX tool's on a seeded image; its run on two images gives the
  clean metrics of ``run_evaluation``, and ``robustness_eval.py`` reads its
  ``--out`` json;
- ``print_config_torch``, ``get_image_metas_torch`` and
  ``browse_dataset_torch`` print / write what the JAX tools do (the drawn
  training samples byte for byte); ``pascal_voc_torch`` and
  ``cityscapes_torch`` write the JAX converters' json on a tiny devkit;
- ``analyze_logs.py`` (which imports neither package) parses the port's
  ``TextLoggerHook`` lines;
- ``collect_env`` has its keys and says "no card" here;
- a checkpoint published by ``publish_model_torch`` has the sha256 prefix
  of its bytes in its name, no optimizer or teacher state, and loads
  through ``init_detector``;
- ``parallel.dist.local_device`` raises without a card.
"""
import hashlib
import importlib.util
import json
import logging
import os
import sys
import time

import cv2
import numpy as np
import pytest

import jax
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.config import Config as JConfig
from boxinstseg_tpu.engine import init_variables
from boxinstseg_tpu.registry import build_dataset as j_build_dataset
from boxinstseg_tpu.registry import build_detector as j_build
from test_box2mask_model import synth_batch as b2m_batch
from test_box2mask_model import tiny_cfg as tiny_b2m_cfg
from test_torch_eval import eval_set  # noqa: F401  (fixture)
from test_torch_slice import make_batch, tiny_cfg

from boxinstseg_tpu_torch.apis.inference import init_detector
from boxinstseg_tpu_torch.apis.test import run_evaluation
from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.engine.hooks import TextLoggerHook
from boxinstseg_tpu_torch.parallel import dist as pdist
from boxinstseg_tpu_torch.registry import build_dataset
from boxinstseg_tpu_torch.utils.env import NO_CARD, collect_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(rel):
    path = os.path.join(ROOT, rel)
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0].replace('-', '_')
        + '_under_test', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_tool(rel, argv, monkeypatch):
    """A JAX tool's ``main()`` (it reads ``sys.argv``)."""
    monkeypatch.setattr(sys, 'argv', [rel] + list(argv))
    return load_tool(rel).main()


def write_cfg(path, cd):
    path.write_text('\n'.join(f'{k} = {v!r}' for k, v in cd.items()))
    return str(path)


def jax_param_count(cfg, batch):
    jm = j_build(cfg)
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)}, batch,
                       np.zeros((), np.int32), method=jm.loss)
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(v['params']))


@pytest.mark.parametrize('family', ['boxinst', 'box2mask'])
def test_get_flops_param_count_matches_jax(family, tmp_path):
    if family == 'boxinst':
        cfg, batch, shape = tiny_cfg(1), make_batch(0), (128, 160)
    else:
        cfg, shape = tiny_b2m_cfg(), (64, 64)
        batch = {k: np.asarray(x) for k, x in b2m_batch(
            np.random.RandomState(0)).items()}
    out = load_tool('tools/analysis_tools/get_flops_torch.py').main([
        write_cfg(tmp_path / 'cfg.py', dict(model=cfg)), '--shape',
        str(shape[0]), str(shape[1]), '--device', 'cpu'])
    assert out['params'] == jax_param_count(cfg, batch)
    assert out['flops'] > 0
    if family == 'box2mask':
        layers = cfg['panoptic_head']['pixel_decoder']['num_encoder_layers']
        msda = out['by_op']['boxinstseg.msda_forward']
        assert msda > 0 and msda % layers == 0
    else:
        assert not any('boxinstseg' in k for k in out['by_op'])


@pytest.mark.parametrize('train', [False, True])
def test_benchmark_runs_on_the_cpu(train, tmp_path, capsys):
    cd = dict(model=tiny_cfg(1),
              optimizer=dict(type='SGD', lr=0.01, momentum=0.9),
              data=dict(samples_per_gpu=2))
    argv = [write_cfg(tmp_path / 'cfg.py', cd), '--height', '128',
            '--width', '160', '--iters', '2', '--batch-size', '2',
            '--max-gts', '4', '--device', 'cpu'] + (['--train'] if train
                                                    else [])
    res = load_tool('tools/analysis_tools/benchmark_torch.py').main(argv)
    assert res['kind'] == ('train' if train else 'predict')
    assert res['min_ms'] <= res['median_ms'] <= res['max_ms']
    assert res['images_per_s'] == pytest.approx(2e3 / res['median_ms'])
    assert 'no card' in res['device'] and 'peak_gib' not in res
    assert 'no card' in capsys.readouterr().out


@pytest.fixture(scope='module')
def saved(eval_set, tmp_path_factory):  # noqa: F811
    """(config file, results json, the config dict) of the evaluation
    set."""
    tm, _, _, cd = eval_set
    root = tmp_path_factory.mktemp('tools')
    cfg = Config.fromdict(cd)
    path = str(root / 'results.json')
    run_evaluation(tm, build_dataset({**cfg.data['test'], 'test_mode': True}),
                   cfg, metrics=['bbox'], save_results=path)
    return write_cfg(root / 'cfg.py', cd), path, cd


def test_eval_metric_matches_jax(saved, monkeypatch, capsys):
    cfg_file, results, _ = saved
    got = load_tool('tools/analysis_tools/eval_metric_torch.py').main(
        [cfg_file, results])
    capsys.readouterr()
    run_jax_tool('tools/analysis_tools/eval_metric.py', [cfg_file, results],
                 monkeypatch)
    want = json.loads(capsys.readouterr().out)
    assert got == want
    assert got['bbox_mAP'] > 0.3 and got['segm_mAP'] > 0.1


def test_analyze_results_matches_jax(saved, tmp_path, monkeypatch):
    cfg_file, results, _ = saved
    argv = [cfg_file, results, None, '--topk', '2', '--show-score-thr',
            '0.1']
    scores = load_tool('tools/analysis_tools/analyze_results_torch.py').main(
        argv[:2] + [str(tmp_path / 'got')] + argv[3:])
    run_jax_tool('tools/analysis_tools/analyze_results.py',
                 argv[:2] + [str(tmp_path / 'want')] + argv[3:], monkeypatch)
    assert len(scores) == 4 and max(scores) > 0
    for group in ('best', 'worst'):
        names = sorted(os.listdir(tmp_path / 'want' / group))
        assert sorted(os.listdir(tmp_path / 'got' / group)) == names
        assert len(names) == 2
        for n in names:
            assert (tmp_path / 'got' / group / n).read_bytes() == \
                (tmp_path / 'want' / group / n).read_bytes()


def test_confusion_matrix_matches_jax(saved, tmp_path, monkeypatch):
    cfg_file, results, _ = saved
    argv = [cfg_file, results, None, '--score-thr', '0.0']
    got = load_tool('tools/analysis_tools/confusion_matrix_torch.py').main(
        argv[:2] + [str(tmp_path / 'got')] + argv[3:])
    run_jax_tool('tools/analysis_tools/confusion_matrix.py',
                 argv[:2] + [str(tmp_path / 'want')] + argv[3:], monkeypatch)
    want = np.load(tmp_path / 'want' / 'confusion_matrix.npy')
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.load(tmp_path / 'got' / 'confusion_matrix.npy'), want)
    assert np.trace(got) > 0
    assert (tmp_path / 'got' / 'confusion_matrix.png').exists()


def test_coco_error_analysis_matches_jax(saved, tmp_path, monkeypatch):
    cfg_file, results, _ = saved
    got = load_tool('tools/analysis_tools/coco_error_analysis_torch.py'
                    ).main([results, str(tmp_path / 'got'), '--config',
                            cfg_file, '--types', 'bbox', 'segm'])
    run_jax_tool('tools/analysis_tools/coco_error_analysis.py',
                 [results, str(tmp_path / 'want'), '--config', cfg_file,
                  '--types', 'bbox', 'segm'], monkeypatch)
    for t in ('bbox', 'segm'):
        with open(tmp_path / 'want' / f'{t}_analysis.json') as f:
            want = json.load(f)
        assert json.loads(json.dumps(got[t])) == want
        assert want['mean']['C50'] > 0


@pytest.mark.parametrize('corruption', ['gaussian_noise', 'gaussian_blur',
                                        'brightness', 'contrast',
                                        'pixelate'])
def test_corruptions_match_jax_bytes(corruption):
    port = load_tool('tools/analysis_tools/test_robustness_torch.py')
    ref = load_tool('tools/analysis_tools/test_robustness.py')
    assert port.CORRUPTIONS == ref.CORRUPTIONS
    img = np.random.RandomState(3).randint(0, 255, (45, 61, 3)).astype(
        np.uint8)
    for severity in range(1, 6):
        got = port.corrupt(img, corruption, severity)
        want = ref.corrupt(img, corruption, severity)
        assert got.dtype == want.dtype == np.uint8
        assert got.tobytes() == want.tobytes(), severity
        assert not np.array_equal(got, img)


def test_robustness_run_and_summary(
        eval_set, saved, tmp_path, capsys, monkeypatch):  # noqa: F811
    tm, _, _, cd = eval_set
    cfg_file = saved[0]
    ckpt = str(tmp_path / 'model.pth')
    torch.save({'state_dict': tm.state_dict()}, ckpt)
    out = str(tmp_path / 'robust.json')
    summary = load_tool('tools/analysis_tools/test_robustness_torch.py'
                        ).main([cfg_file, ckpt, '--corruptions',
                                'brightness', '--severities', '1', '5',
                                '--eval', 'bbox', '--max-images', '2',
                                '--out', out, '--device', 'cpu'])
    cfg = Config.fromdict(cd)
    clean = run_evaluation(tm, build_dataset({**cfg.data['test'],
                                              'test_mode': True}), cfg,
                           metrics=['bbox'], max_images=2)
    assert summary['clean'] == clean
    assert set(summary['brightness']) == {1, 5}
    assert summary['brightness'][5] != clean
    capsys.readouterr()
    run_jax_tool('tools/analysis_tools/robustness_eval.py',
                 [out, '--aggregate', 'all', '--prints', 'P', 'mPC'],
                 monkeypatch)
    printed = capsys.readouterr().out
    assert f'[mPC] (bbox_mAP) = {summary["mPC"]:.4f}' in printed
    assert f'[P] (bbox_mAP) = {clean["bbox_mAP"]:.4f}' in printed


def test_print_config_and_image_metas_match_jax(saved, tmp_path, capsys,
                                               monkeypatch):
    cfg_file = saved[0]
    opts = ['--cfg-options', 'model.test_cfg.max_per_img=7']
    cfg = load_tool('tools/misc/print_config_torch.py').main([cfg_file]
                                                             + opts)
    got = capsys.readouterr().out
    run_jax_tool('tools/misc/print_config.py', [cfg_file] + opts,
                 monkeypatch)
    assert got == capsys.readouterr().out
    assert cfg.model.test_cfg.max_per_img == 7
    metas = load_tool('tools/misc/get_image_metas_torch.py').main([
        cfg_file, '--out', str(tmp_path / 'got.json')])
    run_jax_tool('tools/misc/get_image_metas.py',
                 [cfg_file, '--out', str(tmp_path / 'want.json')],
                 monkeypatch)
    assert (tmp_path / 'got.json').read_text() == \
        (tmp_path / 'want.json').read_text()
    assert len(metas) == 4


def test_browse_dataset_matches_jax(saved, tmp_path, monkeypatch):
    cd = dict(saved[2])
    test = cd['data']['test']
    norm = dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                std=[58.395, 57.12, 57.375], to_rgb=True)
    cd['data'] = dict(cd['data'], train=dict(
        type='CocoDataset', ann_file=test['ann_file'],
        img_prefix=test['img_prefix'], classes=test['classes'],
        pipeline=[dict(type='LoadImageFromFile'),
                  dict(type='LoadAnnotations', with_bbox=True),
                  dict(type='Resize', img_scale=(160, 128), keep_ratio=True),
                  dict(type='RandomFlip', flip_ratio=0.5), norm,
                  dict(type='Pad', size_divisor=32),
                  dict(type='DefaultFormatBundle'),
                  dict(type='Collect',
                       keys=['img', 'gt_bboxes', 'gt_labels'])]))
    cfg_file = write_cfg(tmp_path / 'cfg.py', cd)
    n = load_tool('tools/misc/browse_dataset_torch.py').main([
        cfg_file, '--output-dir', str(tmp_path / 'got'), '--number', '3'])
    run_jax_tool('tools/misc/browse_dataset.py',
                 [cfg_file, '--output-dir', str(tmp_path / 'want'),
                  '--number', '3'], monkeypatch)
    names = sorted(os.listdir(tmp_path / 'want'))
    assert sorted(os.listdir(tmp_path / 'got')) == names and n == 3
    for name in names:
        assert (tmp_path / 'got' / name).read_bytes() == \
            (tmp_path / 'want' / name).read_bytes()


def write_voc(root):
    voc = root / 'VOC2007'
    (voc / 'Annotations').mkdir(parents=True)
    (voc / 'ImageSets' / 'Main').mkdir(parents=True)
    (voc / 'ImageSets' / 'Main' / 'train.txt').write_text('a\nb\n')
    for stem, objs in (('a', [('dog', 0, 10, 20, 30, 40)]),
                       ('b', [('cat', 1, 5, 6, 50, 60),
                              ('person', 0, 1, 2, 3, 4),
                              ('unicorn', 0, 1, 2, 3, 4)])):
        body = ''.join(
            f'<object><name>{n}</name><difficult>{d}</difficult><bndbox>'
            f'<xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax>'
            f'<ymax>{y2}</ymax></bndbox></object>'
            for n, d, x1, y1, x2, y2 in objs)
        (voc / 'Annotations' / f'{stem}.xml').write_text(
            f'<annotation><size><width>64</width><height>48</height></size>'
            f'{body}</annotation>')


def write_cityscapes(root):
    city = root / 'gtFine' / 'train' / 'ulm'
    city.mkdir(parents=True)
    (city / 'ulm_000000_000019_gtFine_polygons.json').write_text(json.dumps(
        dict(imgWidth=64, imgHeight=32, objects=[
            dict(label='car', polygon=[[1, 1], [20, 1], [20, 10]]),
            dict(label='persongroup', polygon=[[3, 3], [9, 3], [9, 9],
                                               [3, 9]]),
            dict(label='sky', polygon=[[0, 0], [5, 0], [5, 5]])])))


@pytest.mark.parametrize('dataset', ['pascal_voc', 'cityscapes'])
def test_dataset_converters_match_jax(dataset, tmp_path, monkeypatch):
    src = tmp_path / 'src'
    (write_voc if dataset == 'pascal_voc' else write_cityscapes)(src)
    extra = ['--years', '2007', '--splits', 'train'] \
        if dataset == 'pascal_voc' else ['--splits', 'train']
    load_tool(f'tools/dataset_converters/{dataset}_torch.py').main(
        [str(src), '-o', str(tmp_path / 'got')] + extra)
    run_jax_tool(f'tools/dataset_converters/{dataset}.py',
                 [str(src), '-o', str(tmp_path / 'want')] + extra,
                 monkeypatch)
    names = sorted(os.listdir(tmp_path / 'want'))
    assert sorted(os.listdir(tmp_path / 'got')) == names and names
    for n in names:
        got = json.loads((tmp_path / 'got' / n).read_text())
        assert got == json.loads((tmp_path / 'want' / n).read_text())
        # VOC: the unknown class dropped; Cityscapes: 'sky' dropped, the
        # group kept as a crowd
        assert len(got['annotations']) == {'pascal_voc': 3,
                                           'cityscapes': 2}[dataset]


def test_analyze_logs_reads_the_ports_log(tmp_path, capsys, monkeypatch):
    log = tmp_path / 'train.log'
    logger = logging.getLogger('test_torch_tools.analyze_logs')
    logger.propagate = False
    logger.setLevel(logging.INFO)
    handler = logging.FileHandler(log)
    logger.addHandler(handler)
    hook = TextLoggerHook(2, logger, 6, [], global_batch=4)
    try:
        for i in range(6):
            hook.before_step(i)
            time.sleep(0.02)                 # a step of measurable time
            hook.after_step(i, None, dict(
                loss=torch.tensor(2.0 - 0.25 * i),
                loss_cls=torch.tensor(0.5), lr=torch.tensor(0.01),
                data_time=0.001))
    finally:
        logger.removeHandler(handler)
        handler.close()
    analyze = load_tool('tools/analysis_tools/analyze_logs.py')
    iters, series = analyze.parse(str(log))
    assert iters == [2, 4, 6]
    assert series['loss'] == pytest.approx([1.75, 1.25, 0.75])
    assert series['loss_cls'] == [0.5] * 3
    assert series['data_time'] == pytest.approx([0.001] * 3, abs=1e-3)
    assert len(series['time']) == 3
    for t, rate in zip(series['time'], series['img_per_sec']):
        assert t >= 0.02 and rate == pytest.approx(4 / t, rel=0.1)
    run_jax_tool('tools/analysis_tools/analyze_logs.py',
                 ['cal_train_time', str(log)], monkeypatch)
    assert 's/iter' in capsys.readouterr().out


def test_collect_env_has_its_keys():
    info = collect_env()
    for key in ('sys.platform', 'Python', 'PyTorch', 'CUDA (torch build)',
                'cuDNN', 'nvcc', 'GPU count', 'GPU 0',
                'nvidia-smi name, power.limit', 'boxinstseg_tpu_torch'):
        assert isinstance(info[key], str) and info[key], key
    assert info['PyTorch'] == torch.__version__
    if not torch.cuda.is_available():
        assert info['GPU 0'] == info['nvidia-smi name, power.limit'] \
            == NO_CARD


def test_published_checkpoint_loads_through_init_detector(
        saved, eval_set, tmp_path):  # noqa: F811
    tm = eval_set[0]
    cfg_file = saved[0]
    raw = str(tmp_path / 'iter_2.pth')
    torch.save({'state_dict': tm.state_dict(), 'optimizer': {'state': {}},
                '_iter': 2, 'meta': dict(seed=0),
                'teacher_state_dict': tm.state_dict(),
                'avg_loss_ins': torch.tensor(1.0)}, raw)
    final = load_tool('tools/model_converters/publish_model_torch.py'
                      ).main([raw, str(tmp_path / 'boxinst_tiny.pth')])
    with open(final, 'rb') as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    assert os.path.basename(final) == f'boxinst_tiny-{sha[:8]}.pth'
    ckpt = torch.load(final, map_location='cpu', weights_only=False)
    assert set(ckpt) == {'state_dict', 'meta'}
    model, _ = init_detector(cfg_file, final, device='cpu')
    for k, v in tm.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_local_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pdist.local_device()


def test_jax_and_port_datasets_agree(saved):
    # the tools above compare outputs built on the two packages' datasets
    cd = saved[2]
    ours = build_dataset({**Config.fromdict(cd).data['test'],
                          'test_mode': True})
    theirs = j_build_dataset({**JConfig.fromdict(cd).data['test'],
                              'test_mode': True})
    assert ours.CLASSES == theirs.CLASSES and len(ours) == len(theirs) == 4
    img = cv2.imread(os.path.join(ours.img_prefix,
                                  ours.data_infos[0]['file_name']))
    assert img is not None
