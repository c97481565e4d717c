"""The port's evaluation path against the JAX package, on the CPU.

- the mask resize chain (``upsample_masks``: x4 AdelaiDet-aligned or
  plain bilinear, crop, resize to the original shape) against the JAX
  package's numpy x4 and cv2 ``INTER_LINEAR`` calls: atol 1e-5;
- ``postprocess_masks`` and ``format_detection`` against the JAX ones on
  the same seeded outputs, for the FCOS (CondInst), SOLO, MaskFormer
  (``masks_logit``) and panoptic families: binary masks equal except at
  pixels whose continuous value lies within 1e-4 of the threshold; labels,
  FCOS boxes and panoptic maps exactly; rescored scores within 1e-5;
- the copied RLE codec against the JAX package's: the same strings;
  ``evaluate_coco`` against the JAX one (every stat exactly) and against
  the pycocotools transcription in ``tests/oracles/``;
- ``run_evaluation`` in both packages on one COCO-style set of four
  images on disk, with the same tiny CondInst weights: bbox and segm
  stats within 1e-6. The ground truth is the port's own top detections,
  so the APs are far from 0;
- ``init_detector`` and ``inference_detector`` against the JAX ones;
- ``tools/test_torch.py --device cpu`` on a checkpoint that
  ``train_detector`` wrote, and its refusal of ``--device cuda`` without
  a GPU.
"""
import importlib.util
import json
import os

import cv2
import numpy as np
import pytest

import jax
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.apis import test as japi
from boxinstseg_tpu.apis.inference import \
    inference_detector as j_inference_detector
from boxinstseg_tpu.config import Config as JConfig
from boxinstseg_tpu.core.eval.coco_eval import COCOEvaluator as JEvaluator
from boxinstseg_tpu.core.eval.coco_eval import evaluate_coco as j_evaluate
from boxinstseg_tpu.data import coco_api as jca
from boxinstseg_tpu.engine import init_variables
from boxinstseg_tpu.registry import build_dataset as j_build_dataset
from boxinstseg_tpu.registry import build_detector as j_build
from oracles.pycoco_cocoeval import OracleCOCOeval
from test_cocoeval_vs_pycoco import PKG_TO_ORACLE, make_fixture
from test_torch_slice import _TinyBoxDataset, make_batch, randomize_stats
from test_torch_slice import tiny_cfg as tiny_condinst_cfg

from boxinstseg_tpu_torch.apis import test as tapi
from boxinstseg_tpu_torch.apis.inference import (inference_detector,
                                                 init_detector)
from boxinstseg_tpu_torch.apis.train import train_detector
from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.core.eval.coco_eval import (COCOEvaluator,
                                                      evaluate_coco)
from boxinstseg_tpu_torch.data import coco_api as tca
from boxinstseg_tpu_torch.native import rle_lib
from boxinstseg_tpu_torch.registry import build_dataset, build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELD_ATOL = 1e-5       # continuous fields: resized scores and logits
NEAR = 1e-4             # binary masks may differ this close to a threshold
CANVAS = (16, 20)       # stride-4 maps of a 64x80 canvas
IMG_SHAPE = (60, 75)
ORI_SHAPES = [(45, 56), (90, 113)]


def cv2_field(m, img_shape, ori_shape, aligned):
    """The JAX package's chain for one (h, w) map, as written there."""
    if aligned:
        full = japi._aligned_upsample_np(m.astype(np.float32), 4)
    else:
        full = cv2.resize(m.astype(np.float32), None, fx=4, fy=4,
                          interpolation=cv2.INTER_LINEAR)
    full = full[:img_shape[0], :img_shape[1]]
    return cv2.resize(full, (ori_shape[1], ori_shape[0]),
                      interpolation=cv2.INTER_LINEAR)


@pytest.mark.parametrize('ori_shape', ORI_SHAPES)
@pytest.mark.parametrize('aligned', [True, False])
def test_upsample_masks_matches_cv2(ori_shape, aligned):
    rng = np.random.RandomState(0)
    maps = rng.randn(5, *CANVAS).astype(np.float32) * 3
    got = tapi.upsample_masks(maps, IMG_SHAPE, ori_shape,
                              aligned=aligned).numpy()
    want = np.stack([cv2_field(m, IMG_SHAPE, ori_shape, aligned)
                     for m in maps])
    assert got.shape == want.shape == (5, *ori_shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=FIELD_ATOL)


def assert_masks_match(got, want, fields, thresh):
    """Binary masks equal except within NEAR of ``thresh`` in the
    continuous ``fields`` the JAX side thresholded."""
    assert len(got) == len(want) == len(fields)
    for g, w, f in zip(got, want, fields):
        assert g.dtype == np.uint8 and g.shape == w.shape
        near = np.abs(f - thresh) < NEAR
        assert ((g == w) | near).all()


@pytest.mark.parametrize('ori_shape', ORI_SHAPES)
def test_postprocess_masks_matches_jax(ori_shape):
    rng = np.random.RandomState(1)
    scores = 1 / (1 + np.exp(-3 * rng.randn(6, *CANVAS))).astype(np.float32)
    for aligned, thr in ((True, 0.5), (False, 0.4)):
        got = tapi.postprocess_masks(scores, IMG_SHAPE, ori_shape,
                                     thresh=thr, aligned=aligned)
        want = japi.postprocess_masks(scores, IMG_SHAPE, ori_shape,
                                      thresh=thr, aligned=aligned)
        fields = [cv2_field(m, IMG_SHAPE, ori_shape, aligned)
                  for m in scores]
        assert_masks_match(got, want, fields, thr)
        assert sum(m.sum() for m in got) > 0


def blobs(rng, lead):
    """Logit maps (*lead, *CANVAS): a blob each over noise, so that masks
    have extents inside the image."""
    yy, xx = np.mgrid[:CANVAS[0], :CANVAS[1]]
    cy = rng.uniform(0, CANVAS[0], lead + (1, 1))
    cx = rng.uniform(0, CANVAS[1], lead + (1, 1))
    r2 = rng.uniform(2, 12, lead + (1, 1))
    return (8 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / r2) - 3
            + rng.randn(*lead, *CANVAS)).astype(np.float32)


def fake_outputs(family, rng, b=2, d=8, q=10):
    """Seeded ``predict`` outputs of one output family."""
    valid = rng.rand(b, d) < 0.7
    valid[:, 0] = True
    out = dict(scores=(rng.rand(b, d) * valid).astype(np.float32),
               labels=rng.randint(0, 3, (b, d)).astype(np.int32),
               valid=valid)
    field = blobs(rng, (b, d))
    if family == 'fcos':
        xy = rng.uniform(0, 50, (b, d, 2))
        out['bboxes'] = np.concatenate(
            [xy, xy + rng.uniform(5, 20, (b, d, 2))], -1).astype(np.float32)
        out['masks'] = 1 / (1 + np.exp(-field))
    elif family == 'solo':
        out['masks'] = 1 / (1 + np.exp(-field))
    else:
        out['masks_logit'] = field
        if family == 'panoptic':
            out['pan_cls'] = rng.randn(b, q, 6).astype(np.float32) * 4
            out['pan_masks_logit'] = blobs(rng, (b, q))
    return out


TEST_CFGS = {
    'fcos': {},
    'solo': dict(mask_thr=0.4),
    'maskformer': {},
    'panoptic': dict(panoptic_on=True, object_mask_thr=0.3, iou_thr=0.5,
                     panoptic_fusion=dict(num_things_classes=3,
                                          num_stuff_classes=2)),
}


@pytest.mark.parametrize('ori_shape', ORI_SHAPES)
@pytest.mark.parametrize('family', list(TEST_CFGS))
def test_format_detection_matches_jax(family, ori_shape):
    rng = np.random.RandomState(2)
    out = fake_outputs(family, rng)
    test_cfg = TEST_CFGS[family]
    for i in range(2):
        got = tapi.format_detection(out, i, IMG_SHAPE, ori_shape, test_cfg)
        want = japi.format_detection(out, i, IMG_SHAPE, ori_shape, test_cfg)
        v = out['valid'][i]
        if family == 'fcos':
            thr, key, aligned = 0.5, 'masks', True
        elif family == 'solo':
            thr, key, aligned = 0.4, 'masks', False
        else:
            thr, key, aligned = 0.0, 'masks_logit', False
        fields = [cv2_field(m, IMG_SHAPE, ori_shape, aligned)
                  for m in out[key][i][v]]
        if key == 'masks_logit':
            # the rescored scores, on the detections both keep (non-empty)
            nonempty = np.array([(f > 0).any() for f in fields])
            fields = [f for f, k in zip(fields, nonempty) if k]
            np.testing.assert_allclose(got['bboxes'][:, 4],
                                       want['bboxes'][:, 4], rtol=0,
                                       atol=FIELD_ATOL)
        np.testing.assert_array_equal(got['labels'], want['labels'])
        assert_masks_match(got['masks'], want['masks'], fields, thr)
        if family == 'fcos':
            np.testing.assert_array_equal(got['bboxes'], want['bboxes'])
        else:
            # mask extents: equal where the masks are, within a pixel
            # where a near-threshold pixel decided an extent
            same = np.array([(g == w).all() for g, w in zip(
                got['masks'], want['masks'])], bool)
            np.testing.assert_array_equal(got['bboxes'][same, :4],
                                          want['bboxes'][same, :4])
            assert np.abs(got['bboxes'] - want['bboxes']).max() <= 1
            assert (got['bboxes'][:, 2] - got['bboxes'][:, 0]
                    < ori_shape[1] - 4).any()
        assert got['bboxes'].dtype == np.float64 and len(got) > 0
        if family == 'panoptic':
            pan = got.metainfo['pan_results']
            np.testing.assert_array_equal(pan,
                                          want.metainfo['pan_results'])
            assert pan.shape == ori_shape and len(np.unique(pan)) > 2


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_rle_codec_matches_jax(seed):
    assert rle_lib() is not None
    rng = np.random.RandomState(seed)
    for _ in range(10):
        h, w = rng.randint(1, 70, 2)
        m = (rng.rand(h, w) > rng.rand()).astype(np.uint8)
        got = tca.rle_encode(m)
        assert got == jca.rle_encode(m)
        np.testing.assert_array_equal(tca.rle_decode(got), m)
        np.testing.assert_array_equal(
            tca.rle_decode({'size': [int(h), int(w)],
                            'counts': jca._decode_rle_string(
                                got['counts'].encode())}), m)


def run_evaluator(module, images, gt_anns, dts, cat_ids, iou_type):
    gt = dict(images=images,
              categories=[dict(id=c, name=str(c)) for c in cat_ids],
              annotations=[{**{k: v for k, v in a.items() if k != 'mask'},
                            'segmentation': module.rle_encode(a['mask'])}
                           for a in gt_anns])
    coco = module.COCO(dataset=gt)
    img_ids = [im['id'] for im in images]
    dets = {i: {} for i in img_ids}
    for d in dts:
        e = dets[d['image_id']].setdefault(
            d['category_id'], dict(bboxes=[], scores=[], masks=[]))
        e['bboxes'].append(d['bbox'])
        e['scores'].append(d['score'])
        e['masks'].append(module.rle_encode(d['mask']))
    return coco, img_ids, dets


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('iou_type', ['bbox', 'segm'])
def test_coco_evaluator_matches_jax_and_pycocotools(seed, iou_type):
    images, gt_anns, dts = make_fixture(seed)
    cat_ids = [1, 2, 3, 4]
    coco, img_ids, dets = run_evaluator(tca, images, gt_anns, dts, cat_ids,
                                        iou_type)
    acc = COCOEvaluator(coco, img_ids, cat_ids, iou_type=iou_type).evaluate(
        dets)
    summary = COCOEvaluator.summarize(acc)
    jcoco, _, jdets = run_evaluator(jca, images, gt_anns, dts, cat_ids,
                                    iou_type)
    jacc = JEvaluator(jcoco, img_ids, cat_ids, iou_type=iou_type).evaluate(
        jdets)
    np.testing.assert_array_equal(acc['precision'], jacc['precision'])
    np.testing.assert_array_equal(acc['recall'], jacc['recall'])
    assert summary == JEvaluator.summarize(jacc)
    oracle = OracleCOCOeval(gt_anns, dts, img_ids, cat_ids, iou_type)
    oracle.evaluate_and_accumulate()
    stats = oracle.summarize()
    for i, key in enumerate(PKG_TO_ORACLE):
        assert summary[key] == pytest.approx(stats[i], abs=1e-9), key
    assert 0.05 < summary['mAP'] < 0.95


def test_evaluate_coco_matches_jax():
    images, gt_anns, dts = make_fixture(3, n_imgs=6)
    cat_ids = [1, 2, 3, 4]
    outs = []
    for module, evaluate in ((tca, evaluate_coco), (jca, j_evaluate)):
        coco, img_ids, _ = run_evaluator(module, images, gt_anns, [],
                                         cat_ids, 'segm')
        results = []
        for i in img_ids:
            mine = [d for d in dts if d['image_id'] == i]
            x, y, w, h = (np.array([d['bbox'] for d in mine]).reshape(-1, 4)
                          .T)
            results.append(dict(
                bboxes=np.stack([x, y, x + w, y + h,
                                 [d['score'] for d in mine]], 1),
                labels=np.array([d['category_id'] - 1 for d in mine]),
                masks=[module.rle_encode(d['mask']) for d in mine]))
        outs.append(evaluate(coco, img_ids, cat_ids, results,
                             ['bbox', 'segm']))
    assert outs[0] == outs[1]
    assert outs[0]['segm_mAP'] > 0.05


# ---- end to end -------------------------------------------------------------

H, W = 90, 120          # images on disk; the pipeline resizes to 120x160
CANVASES = [(128, 160)]
TEST_CFG = dict(nms_pre=200, score_thr=0.003,
                nms=dict(type='nms', iou_threshold=0.5), max_per_img=20,
                pre_nms_limit=300)


def pipeline():
    return [dict(type='LoadImageFromFile'),
            dict(type='MultiScaleFlipAug', img_scale=(160, 128), flip=False,
                 transforms=[
                     dict(type='Resize', keep_ratio=True),
                     dict(type='RandomFlip'),
                     dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                          std=[58.395, 57.12, 57.375], to_rgb=True),
                     dict(type='Pad', size_divisor=32),
                     dict(type='ImageToTensor', keys=['img']),
                     dict(type='Collect', keys=['img'])])]


def cfg_dict(ann_file, img_dir):
    model = tiny_condinst_cfg(1)
    model['test_cfg'] = TEST_CFG
    return dict(model=model, canvases=CANVASES,
                data=dict(samples_per_gpu=2, workers_per_gpu=1,
                          test=dict(type='CocoDataset', ann_file=ann_file,
                                    img_prefix=img_dir + '/',
                                    classes=('a', 'b', 'c', 'd'),
                                    pipeline=pipeline())),
                test_pipeline=pipeline())


def write_images(root, n=4, seed=0):
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, 'images')
    os.makedirs(img_dir, exist_ok=True)
    images = []
    for i in range(n):
        img = rng.randint(0, 255, (H, W, 3)).astype(np.uint8)
        for _ in range(3):
            x, y = rng.randint(0, W - 30), rng.randint(0, H - 30)
            img[y:y + 30, x:x + 30] = rng.randint(0, 255, 3)
        cv2.imwrite(os.path.join(img_dir, f'{i}.png'), img)
        images.append(dict(id=i + 1, width=W, height=H, file_name=f'{i}.png'))
    return images, img_dir


def write_ann(path, images, anns):
    with open(path, 'w') as f:
        json.dump(dict(images=images, annotations=anns, categories=[
            dict(id=c + 1, name=n) for c, n in enumerate('abcd')]), f)


@pytest.fixture(scope='module')
def eval_set(tmp_path_factory):
    """(port model, JAX model and variables, config dict, dataset paths):
    four images whose ground truth is the port's top detections."""
    root = str(tmp_path_factory.mktemp('eval_set'))
    cfg = tiny_condinst_cfg(1)
    cfg['test_cfg'] = TEST_CFG
    jm = j_build(cfg)
    batch = make_batch(0)
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)},
                       {k: np.asarray(x) for k, x in batch.items()},
                       np.zeros((), np.int32), method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, v)
    reg = v['params']['bbox_head_m']['conv_reg']
    reg['kernel'] = reg['kernel'] * 30
    reg['bias'] = reg['bias'] + 1.5
    v = {'params': v['params'], 'batch_stats': randomize_stats(
        dict(v['batch_stats']), np.random.RandomState(1))}
    tm = build_detector(cfg)
    tm.load_state_dict(params_from_jax(v['params'], v['batch_stats']),
                       strict=True)
    tm.eval()

    images, img_dir = write_images(root)
    ann_file = os.path.join(root, 'ann.json')
    write_ann(ann_file, images, [])
    pcfg = Config.fromdict(cfg_dict(ann_file, img_dir))
    dataset = build_dataset({**pcfg.data['test'], 'test_mode': True})
    dets = os.path.join(root, 'dets.json')
    tapi.run_evaluation(tm, dataset, pcfg, metrics=['bbox'],
                        save_results=dets)
    with open(dets) as f:
        dets = json.load(f)
    anns = []
    for img, r in zip(images, dets):
        for box, label, rle in list(zip(r['bboxes'], r['labels'],
                                        r['masks']))[:4]:
            x1, y1, x2, y2, _ = box
            area = float(tca.rle_decode(rle).sum())
            if x2 - x1 < 2 or y2 - y1 < 2 or area < 4:
                continue
            anns.append(dict(id=len(anns) + 1, image_id=img['id'],
                             category_id=label + 1, iscrowd=0, area=area,
                             bbox=[x1, y1, x2 - x1, y2 - y1],
                             segmentation=rle))
    assert len(anns) >= 8
    write_ann(ann_file, images, anns)
    return tm, jm, v, cfg_dict(ann_file, img_dir)


def test_run_evaluation_matches_jax(eval_set):
    tm, jm, v, cd = eval_set
    pcfg, jcfg = Config.fromdict(cd), JConfig.fromdict(cd)
    got = tapi.run_evaluation(
        tm, build_dataset({**pcfg.data['test'], 'test_mode': True}), pcfg)
    want = japi.run_evaluation(
        jm, v, j_build_dataset({**jcfg.data['test'], 'test_mode': True}),
        jcfg)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert want['bbox_mAP'] > 0.3 and want['segm_mAP'] > 0.1


def test_inference_detector_matches_jax(eval_set, tmp_path):
    tm, jm, v, cd = eval_set
    ckpt = str(tmp_path / 'model.pth')
    torch.save({'state_dict': tm.state_dict()}, ckpt)
    model, cfg = init_detector(Config.fromdict(cd), ckpt, device='cpu')
    assert not model.training
    img = cv2.imread(os.path.join(cd['data']['test']['img_prefix'], '1.png'))
    got = inference_detector(model, cfg, img)
    want = j_inference_detector(jm, v, JConfig.fromdict(cd), img)
    np.testing.assert_array_equal(got['labels'], want['labels'])
    np.testing.assert_allclose(got['bboxes'], want['bboxes'], rtol=1e-4,
                               atol=1e-4)
    assert len(got['masks']) == len(want['masks']) >= 10
    assert got['masks'][0].shape == (H, W)
    with pytest.raises(KeyError):
        sd = dict(tm.state_dict())
        sd.pop('mask_head.param_conv.weight')
        torch.save({'state_dict': sd}, ckpt)
        init_detector(Config.fromdict(cd), ckpt, device='cpu')


def load_test_tool():
    spec = importlib.util.spec_from_file_location(
        'test_torch_tool', os.path.join(ROOT, 'tools', 'test_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_test_tool_evaluates_a_trained_checkpoint(eval_set, tmp_path):
    _, _, _, cd = eval_set
    cfg = Config.fromdict(dict(
        cd, optimizer=dict(type='SGD', lr=0.01, momentum=0.9),
        runner=dict(type='IterBasedRunner', max_iters=2), max_gts=4,
        work_dir=str(tmp_path)))
    torch.manual_seed(0)
    result = train_detector(build_detector(cfg.model), _TinyBoxDataset(),
                            cfg, device='cpu')
    cfg_file = tmp_path / 'cfg.py'
    cfg_file.write_text('\n'.join(f'{k} = {v!r}' for k, v in cd.items()))
    out = tmp_path / 'metrics.json'
    metrics = load_test_tool().main([
        str(cfg_file), result.checkpoint, '--device', 'cpu', '--eval',
        'bbox', 'segm', '--out', str(out), '--cfg-options',
        'model.test_cfg.max_per_img=5'])
    assert json.loads(out.read_text()) == metrics
    assert {'bbox_mAP', 'segm_mAP'} <= set(metrics)
    assert all(np.isfinite(x) for x in metrics.values())


def test_test_tool_refuses_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='no CUDA device'):
        load_test_tool().main(['cfg.py', 'ckpt.pth'])
