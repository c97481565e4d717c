"""The port's prior generators, assigners, samplers and assigner zoo
(``ops/anchors.py``, ``core/targets/{assigners,samplers,assigner_zoo}.py``)
against the JAX package's, on the CPU, at small sizes.

The same seeded numpy inputs go through both; the samplers get the JAX
function's own uniforms (drawn here with its keys in its order), so the
selections must be equal. Floats: atol 1e-5 / rtol 1e-4; integer and
boolean outputs exactly. ``optimize_anchors_torch.py`` is held to the JAX
tool on a tiny synthetic COCO file with the same seed.
"""
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import boxinstseg_tpu.core.targets.assigner_zoo as JZ
import boxinstseg_tpu.core.targets.assigners as JA
import boxinstseg_tpu.core.targets.samplers as JS
import boxinstseg_tpu.ops.anchors as JAN

import boxinstseg_tpu_torch.core.targets.assigner_zoo as TZ
import boxinstseg_tpu_torch.core.targets.assigners as TA
import boxinstseg_tpu_torch.core.targets.samplers as TS
import boxinstseg_tpu_torch.ops.anchors as TAN
from boxinstseg_tpu_torch.registry import PRIOR_GENERATORS

ATOL, RTOL = 1e-5, 1e-4


def close(got, want, exact=False):
    if got is None or want is None:
        assert got is None and want is None
        return
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact or want.dtype.kind in 'biu':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def t(x):
    return torch.from_numpy(np.array(x))


def boxes(rng, n, size=64.0, min_wh=2.0):
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * size / 2 + min_wh
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def gts(rng, k=6, live=4):
    valid = np.zeros(k, bool)
    valid[:live] = True
    return boxes(rng, k), valid, rng.randint(0, 5, k).astype(np.int32)


# ------------------------------------------------------------------ anchors

GENERATORS = {
    'retina': dict(type='AnchorGenerator', strides=[8, 16, 32],
                   ratios=[0.5, 1.0, 2.0], octave_base_scale=4,
                   scales_per_octave=3),
    'rpn': dict(type='AnchorGenerator', strides=[4, 8], ratios=[0.5, 1.0],
                scales=[8], scale_major=False, center_offset=0.5),
    'ssd300': dict(type='SSDAnchorGenerator', scale_major=False,
                   input_size=300, basesize_ratio_range=(0.15, 0.9),
                   strides=[8, 16, 32, 64, 100, 300],
                   ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]]),
    'legacy': dict(type='LegacyAnchorGenerator', strides=[4, 8],
                   ratios=[0.5, 1.0, 2.0], scales=[8], center_offset=0.5),
    'legacy-ssd': dict(type='LegacySSDAnchorGenerator', scale_major=False,
                       input_size=300, basesize_ratio_range=(0.15, 0.9),
                       strides=[8, 16, 32, 64, 100, 300],
                       ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]]),
    'yolo': dict(type='YOLOAnchorGenerator', strides=[32, 16, 8],
                 base_sizes=[[(116, 90), (156, 198), (373, 326)],
                             [(30, 61), (62, 45), (59, 119)],
                             [(10, 13), (16, 30), (33, 23)]]),
}


def _sizes(n):
    return [(11, 13), (6, 7), (3, 4), (2, 2), (1, 2), (1, 1)][:n]


@pytest.mark.parametrize('name', sorted(GENERATORS))
def test_prior_generators_equal_jax(name):
    cfg = dict(GENERATORS[name])
    kind = cfg.pop('type')
    jg = getattr(JAN, kind)(**cfg)
    tg = PRIOR_GENERATORS.build(dict(GENERATORS[name]))
    assert tg.num_base_priors == jg.num_base_priors
    for a, b in zip(tg.base_anchors, jg.base_anchors):
        close(t(a), b)
    sizes = _sizes(tg.num_levels)
    for a, b in zip(tg.grid_priors(sizes, device='cpu'),
                    jg.grid_priors(sizes)):
        close(a, b)
    for a, b in zip(tg.valid_flags(sizes, (70, 50), device='cpu'),
                    jg.valid_flags(sizes, (70, 50))):
        close(a, b)
    idx = np.array([0, 3, 17, 40, 7], np.int64)
    close(tg.sparse_priors(t(idx), sizes[0], 0),
          jg.sparse_priors(jnp.asarray(idx.astype(np.int32)), sizes[0], 0))


def test_yolo_responsible_flags_equal_jax():
    cfg = dict(GENERATORS['yolo'])
    cfg.pop('type')
    jg, tg = JAN.YOLOAnchorGenerator(**cfg), TAN.YOLOAnchorGenerator(**cfg)
    rng = np.random.RandomState(0)
    b, valid, _ = gts(rng, 7, 5)
    sizes = [(3, 4), (6, 8), (12, 16)]
    for gv in (None, valid):
        for a, c in zip(
                tg.responsible_flags(sizes, t(b),
                                     None if gv is None else t(gv)),
                jg.responsible_flags(sizes, jnp.asarray(b),
                                     None if gv is None
                                     else jnp.asarray(gv))):
            close(a, c)


# ---------------------------------------------------------------- max IoU

@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_bbox_overlaps_equal_jax(mode):
    rng = np.random.RandomState(1)
    a, b = boxes(rng, 9), boxes(rng, 5)
    a[0, 2:] = a[0, :2]                         # an empty box
    close(TA.bbox_overlaps(t(a), t(b), mode), JA.bbox_overlaps(a, b, mode))


MAX_IOU = {
    'default': dict(),
    'neg-range': dict(neg_iou_thr=(0.1, 0.4), pos_iou_thr=0.3),
    'no-low-quality': dict(match_low_quality=False),
    'argmax-only': dict(gt_max_assign_all=False, min_pos_iou=0.1),
    'ignore': dict(ignore_iof_thr=0.5),
}


@pytest.mark.parametrize('name', sorted(MAX_IOU))
def test_max_iou_assign_equals_jax(name):
    rng = np.random.RandomState(2)
    anchors = boxes(rng, 60)
    anchors[5] = anchors[6]                     # a tied pair
    g, valid, labels = gts(rng)
    g[:3] = anchors[[10, 20, 30]] + 0.5         # some high-IoU anchors
    kw = dict(MAX_IOU[name])
    jkw, tkw = dict(kw), dict(kw)
    if 'ignore_iof_thr' in kw:
        ign = boxes(rng, 3)
        iv = np.array([True, True, False])
        jkw.update(gt_bboxes_ignore=jnp.asarray(ign),
                   ignore_valid=jnp.asarray(iv))
        tkw.update(gt_bboxes_ignore=t(ign), ignore_valid=t(iv))
    want = JA.max_iou_assign(jnp.asarray(anchors), jnp.asarray(g),
                             jnp.asarray(valid), gt_labels=jnp.asarray(labels),
                             **jkw)
    got = TA.max_iou_assign(t(anchors), t(g), t(valid), gt_labels=t(labels),
                            **tkw)
    for a, b in zip(got, want):
        close(a, b)
    assert (got[0] > 0).any() and (got[0] == 0).any()


def test_pseudo_and_random_sample_equal_jax():
    rng = np.random.RandomState(3)
    assigned = rng.randint(-1, 4, 200).astype(np.int32)
    for a, b in zip(TA.pseudo_sample(t(assigned)),
                    JA.pseudo_sample(jnp.asarray(assigned))):
        close(a, b)
    key = jax.random.PRNGKey(5)
    noise = [t(np.asarray(jax.random.uniform(k, (200,))))
             for k in jax.random.split(key)]
    for ub in (-1.0, 1.0):
        want = JA.random_sample(jnp.asarray(assigned), key, 64, 0.25, ub)
        got = TA.random_sample(t(assigned), 64, 0.25, ub, noise=noise)
        for a, b in zip(got, want):
            close(a, b)
    # a generator's draw selects as many
    pos, neg = TA.random_sample(t(assigned), 64, 0.25,
                                generator=torch.Generator().manual_seed(0))
    assert int(pos.sum()) == 16
    assert int(neg.sum()) == min(48, int((assigned == 0).sum()))


# ---------------------------------------------------------------- samplers

def _jax_noise(key, count, n):
    return [t(np.asarray(jax.random.uniform(k, (n,))))
            for k in jax.random.split(key, count)]


def _ib_noise(key, n):
    k1, k2 = jax.random.split(key)
    return [t(np.asarray(jax.random.uniform(k, (n,))))
            for k in (k1, k2, jax.random.fold_in(k2, 1))]


@pytest.mark.parametrize('num_expected', [8, 40, 400])
def test_instance_balanced_pos_sample_equals_jax(num_expected):
    rng = np.random.RandomState(4)
    assigned = rng.choice([0, 0, 1, 2, 2, 2, 3, 5], 300).astype(np.int32)
    key = jax.random.PRNGKey(1)
    want = JS.instance_balanced_pos_sample(jnp.asarray(assigned), key,
                                           num_expected, max_gts=6)
    got = TS.instance_balanced_pos_sample(t(assigned), num_expected,
                                          max_gts=6,
                                          noise=_ib_noise(key, 300))
    close(got, want)


@pytest.mark.parametrize('floor_thr, floor_fraction', [(-1.0, 0.0),
                                                       (0.0, 0.5),
                                                       (0.1, 0.3)])
def test_iou_balanced_neg_sample_equals_jax(floor_thr, floor_fraction):
    rng = np.random.RandomState(5)
    assigned = rng.choice([-1, 0, 0, 0, 1], 300).astype(np.int32)
    ov = (rng.rand(300) * 0.5).astype(np.float32)
    ov[::7] = 0.0
    key = jax.random.PRNGKey(2)
    want = JS.iou_balanced_neg_sample(jnp.asarray(assigned), jnp.asarray(ov),
                                      key, 60, floor_thr, floor_fraction)
    got = TS.iou_balanced_neg_sample(t(assigned), t(ov), 60, floor_thr,
                                     floor_fraction,
                                     noise=_jax_noise(key, 6, 300)[:5])
    close(got, want)


def test_ohem_and_combined_sample_equal_jax():
    rng = np.random.RandomState(6)
    assigned = rng.choice([-1, 0, 0, 1, 2], 256).astype(np.int32)
    loss = rng.rand(256).astype(np.float32)
    for ub in (-1.0, 2.0):
        for a, b in zip(TS.ohem_sample(t(assigned), t(loss), 64, 0.25, ub),
                        JS.ohem_sample(jnp.asarray(assigned),
                                       jnp.asarray(loss), 64, 0.25, ub)):
            close(a, b)
    ov = (rng.rand(256) * 0.6).astype(np.float32)
    key = jax.random.PRNGKey(3)
    kp, kn = jax.random.split(key)
    want = JS.combined_sample(jnp.asarray(assigned), jnp.asarray(ov), key,
                              64, 0.25)
    got = TS.combined_sample(t(assigned), t(ov), 64, 0.25,
                             noise=(_ib_noise(kp, 256),
                                    _jax_noise(kn, 6, 256)[:5]))
    for a, b in zip(got, want):
        close(a, b)


def test_nms_match_groups_and_score_hlr_equal_jax():
    rng = np.random.RandomState(7)
    n = 80
    base = boxes(rng, 8)
    pred = np.repeat(base, 10, 0) + rng.randn(n, 4).astype(np.float32)
    score = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) > 0.2
    close(TS.nms_match_groups(t(pred), t(score), t(valid), 0.5),
          JS.nms_match_groups(jnp.asarray(pred), jnp.asarray(score),
                              jnp.asarray(valid), 0.5))
    assigned = rng.choice([-1, 0, 0, 0, 1], n).astype(np.int32)
    ori = rng.rand(n).astype(np.float32)
    key = jax.random.PRNGKey(4)
    for thr, ori_loss in ((0.3, None), (0.3, ori), (2.0, None)):
        want = JS.score_hlr_neg_sample(
            jnp.asarray(assigned), jnp.asarray(score), jnp.asarray(pred),
            key, 24, score_thr=thr,
            ori_loss=None if ori_loss is None else jnp.asarray(ori_loss))
        got = TS.score_hlr_neg_sample(
            t(assigned), t(score), t(pred), 24, score_thr=thr,
            ori_loss=None if ori_loss is None else t(ori_loss),
            noise=_jax_noise(key, 2, n))
        for a, b in zip(got, want):
            close(a, b)


# ------------------------------------------------------------ assigner zoo

def test_atss_and_task_aligned_equal_jax():
    rng = np.random.RandomState(8)
    anchors = boxes(rng, 90)
    g, valid, labels = gts(rng)
    want = JZ.atss_assign(jnp.asarray(anchors), [50, 30, 10],
                          jnp.asarray(g), jnp.asarray(valid), topk=9,
                          gt_labels=jnp.asarray(labels))
    got = TZ.atss_assign(t(anchors), [50, 30, 10], t(g), t(valid), topk=9,
                         gt_labels=t(labels))
    for a, b in zip(got, want):
        close(a, b)
    assert (got[0] > 0).any()
    scores = rng.rand(90, 5).astype(np.float32)
    dec = anchors + rng.randn(90, 4).astype(np.float32)
    want = JZ.task_aligned_assign(jnp.asarray(scores), jnp.asarray(dec),
                                  jnp.asarray(anchors), jnp.asarray(g),
                                  jnp.asarray(valid), jnp.asarray(labels))
    got = TZ.task_aligned_assign(t(scores), t(dec), t(anchors), t(g),
                                 t(valid), t(labels))
    for a, b in zip(got, want):
        close(a, b)


def test_point_grid_uniform_approx_equal_jax():
    rng = np.random.RandomState(9)
    g, valid, labels = gts(rng)
    xy = (rng.rand(120, 2) * 64).astype(np.float32)
    stride = rng.choice([8.0, 16.0, 32.0], (120, 1)).astype(np.float32)
    pts = np.concatenate([xy, stride], 1)
    for a, b in zip(TZ.point_assign(t(pts), t(g), t(valid), pos_num=2,
                                    gt_labels=t(labels)),
                    JZ.point_assign(jnp.asarray(pts), jnp.asarray(g),
                                    jnp.asarray(valid), pos_num=2,
                                    gt_labels=jnp.asarray(labels))):
        close(a, b)
    anchors = boxes(rng, 70)
    flags = rng.rand(70) > 0.5
    for neg in (0.3, (0.0, 0.3)):
        for all_ in (True, False):
            for a, b in zip(
                    TZ.grid_assign(t(anchors), t(flags), t(g), t(valid),
                                   neg_iou_thr=neg, gt_max_assign_all=all_,
                                   gt_labels=t(labels)),
                    JZ.grid_assign(jnp.asarray(anchors), jnp.asarray(flags),
                                   jnp.asarray(g), jnp.asarray(valid),
                                   neg_iou_thr=neg, gt_max_assign_all=all_,
                                   gt_labels=jnp.asarray(labels))):
                close(a, b)
    pred = anchors + rng.randn(70, 4).astype(np.float32) * 3
    for a, b in zip(TZ.uniform_assign(t(pred), t(anchors), t(g), t(valid),
                                      gt_labels=t(labels)),
                    JZ.uniform_assign(jnp.asarray(pred), jnp.asarray(anchors),
                                      jnp.asarray(g), jnp.asarray(valid),
                                      gt_labels=jnp.asarray(labels))):
        close(a, b)
    approxs = np.repeat(anchors, 3, 0) + rng.randn(210, 4).astype(
        np.float32)
    ign = boxes(rng, 2)
    for wrt in (True, False):
        kw = dict(ignore_iof_thr=0.3, ignore_wrt_candidates=wrt)
        for a, b in zip(
                TZ.approx_max_iou_assign(t(approxs), t(anchors), 3, t(g),
                                         t(valid), gt_bboxes_ignore=t(ign),
                                         gt_labels=t(labels), **kw),
                JZ.approx_max_iou_assign(
                    jnp.asarray(approxs), jnp.asarray(anchors), 3,
                    jnp.asarray(g), jnp.asarray(valid),
                    gt_bboxes_ignore=jnp.asarray(ign),
                    gt_labels=jnp.asarray(labels), **kw)):
            close(a, b)


def test_sim_ota_equals_jax():
    rng = np.random.RandomState(10)
    n = 160
    xy = (rng.rand(n, 2) * 64).astype(np.float32)
    priors = np.concatenate([xy, np.full((n, 2), 8.0, np.float32)], 1)
    g, valid, labels = gts(rng)
    dec = np.concatenate([xy - 6, xy + 6], 1) + rng.randn(n, 4).astype(
        np.float32)
    scores = rng.rand(n, 5).astype(np.float32)
    want = JZ.sim_ota_assign(jnp.asarray(scores), jnp.asarray(priors),
                             jnp.asarray(dec), jnp.asarray(g),
                             jnp.asarray(valid), jnp.asarray(labels))
    got = TZ.sim_ota_assign(t(scores), t(priors), t(dec), t(g), t(valid),
                            t(labels))
    for a, b in zip(got, want):
        close(a, b)
    assert (got[0] > 0).any()


def test_match_costs_and_hungarian_bbox_assign_equal_jax():
    rng = np.random.RandomState(11)
    q, k = 30, 8
    cls = rng.randn(q, 5).astype(np.float32)
    g, valid, labels = gts(rng, k, 5)
    pred = rng.rand(q, 4).astype(np.float32) * 0.5 + 0.2
    close(TZ.focal_loss_cost(t(cls), t(labels)),
          JZ.focal_loss_cost(jnp.asarray(cls), jnp.asarray(labels)))
    close(TZ.bbox_l1_cost(t(pred), t(g / 64)),
          JZ.bbox_l1_cost(jnp.asarray(pred), jnp.asarray(g / 64)))
    b = boxes(rng, q)
    for mode in ('iou', 'giou'):
        close(TZ.iou_cost(t(b), t(g), mode=mode),
              JZ.iou_cost(jnp.asarray(b), jnp.asarray(g), mode=mode))
    mp = rng.randn(q, 6, 7).astype(np.float32)
    gm = (rng.rand(k, 6, 7) > 0.5).astype(np.float32)
    for naive in (True, False):
        close(TZ.dice_cost(t(mp), t(gm), naive_dice=naive),
              JZ.dice_cost(jnp.asarray(mp), jnp.asarray(gm),
                           naive_dice=naive))
    want = JZ.hungarian_bbox_assign(jnp.asarray(pred), jnp.asarray(cls),
                                    jnp.asarray(g), jnp.asarray(valid),
                                    jnp.asarray(labels), (64, 64))
    got = TZ.hungarian_bbox_assign(t(pred), t(cls), t(g), t(valid),
                                   t(labels), (64, 64))
    for a, b in zip(got, want):
        close(a, b)
    assert int((got[0] > 0).sum()) == int(valid.sum())


# ------------------------------------------------------- optimize_anchors

def _coco(root, seed=0):
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(4):
        w, h = [(320, 240), (200, 300), (640, 480), (256, 256)][i]
        images.append(dict(id=i + 1, file_name=f'{i}.jpg', width=w,
                           height=h))
        for _ in range(5):
            bw, bh = rng.randint(8, w // 2), rng.randint(8, h // 2)
            x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=1, bbox=[x, y, bw, bh],
                             area=bw * bh, iscrowd=0))
    ann = os.path.join(root, 'ann.json')
    with open(ann, 'w') as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='thing')]), f)
    cfg = os.path.join(root, 'cfg.py')
    with open(cfg, 'w') as f:
        f.write(f"data = dict(train=dict(type='CocoDataset', "
                f"ann_file={ann!r}, img_prefix={root + '/'!r}, "
                f"classes=('thing',), pipeline=[]))\n")
    return cfg


@pytest.mark.parametrize('algorithm', ['k-means', 'differential_evolution'])
def test_optimize_anchors_torch_equals_jax(algorithm, tmp_path, capsys):
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = _coco(str(tmp_path))
    argv = [cfg, '--algorithm', algorithm, '--num-anchors', '3',
            '--iters', '20', '--input-shape', '320', '320']
    out = {}
    for name in ('optimize_anchors', 'optimize_anchors_torch'):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(root, 'tools', 'analysis_tools',
                               f'{name}.py'))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if name == 'optimize_anchors':
            import sys
            old = sys.argv
            sys.argv = ['optimize_anchors.py', *argv]
            try:
                mod.main()
            finally:
                sys.argv = old
        else:
            out['torch'] = mod.main(argv)
        out[name] = capsys.readouterr().out
    line = [l for l in out['optimize_anchors'].splitlines()
            if l.startswith('Anchor optimize result')]
    assert line and line[0] == f"Anchor optimize result: {out['torch']}"
    assert out['optimize_anchors'] == out['optimize_anchors_torch']
