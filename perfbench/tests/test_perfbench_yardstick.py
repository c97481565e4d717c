"""The yardstick's arithmetic: the generator repeats by seed, the kernels'
operations and bytes and the rooflines against hand counts, the busy time
of the trace reader, and the imports of every file under perfbench/."""
import ast
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
sys.path.insert(0, PB)

from harness import kernels, trace, traffic  # noqa: E402
from harness.train import p_quantile  # noqa: E402
from harness.weights import seeded_weights  # noqa: E402

NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])


@pytest.mark.parametrize('name', ['boxinst_multiscale', 'box2mask_lsj'])
def test_train_generator_repeats_by_seed(name):
    mix = dict(traffic.load_mix(name), pool_batches=4)
    masks = name == 'box2mask_lsj'
    a = traffic.train_samples(mix, 2 ** 31 + 5, NORM, 80, masks)
    b = traffic.train_samples(mix, 2 ** 31 + 5, NORM, 80, masks)
    c = traffic.train_samples(mix, 2 ** 31 + 6, NORM, 80, masks)
    for ba, bb in zip(a, b):
        for sa, sb in zip(ba, bb):
            assert sa.keys() == sb.keys()
            for k in sa:
                np.testing.assert_array_equal(sa[k], sb[k])
    assert any(not np.array_equal(sa['img'], sc['img'])
               for ba, bc in zip(a, c) for sa, sc in zip(ba, bc))
    # another seed runs the same plan of shapes in another order
    def shapes(pool):
        return sorted((tuple(s['img'].shape), len(s['gt_bboxes']))
                      for batch in pool for s in batch)
    assert shapes(a) == shapes(c)


def test_plan_spans_gt_buckets_and_orientations():
    mix = traffic.load_mix('boxinst_multiscale')
    plan = traffic.train_plan(mix)
    counts = [c for p in plan for c in p['counts']]
    assert min(counts) >= 1 and max(counts) <= 32
    assert 5.5 <= sum(counts) / len(counts) <= 8.5
    buckets = {next(g for g in (8, 16, 32) if g >= max(p['counts']))
               for p in plan}
    assert buckets == {8, 16, 32}
    assert sum(not p['landscape'] for p in plan) == 3


def test_predict_generator_repeats_by_seed():
    mix = dict(traffic.load_mix('coco_test_keepratio'), pool_images=4)
    a = traffic.predict_images(mix, 2 ** 33 + 1, NORM)
    b = traffic.predict_images(mix, 2 ** 33 + 1, NORM)
    for sa, sb in zip(a, b):
        np.testing.assert_array_equal(sa['img'], sb['img'])
    assert {s['img'].shape[:2] for s in a} <= {(800, 1067), (1067, 800),
                                                (800, 1199), (1199, 800)}


def test_seeded_weights_repeat_and_follow_the_rule():
    import torch
    shapes = [('a.weight', (64, 32, 3, 3)), ('a.bias', (64,)),
              ('n.weight', (32,)), ('cls.bias', (4,))]
    init = dict(gain=0.5, overrides=[['^cls\\.bias$', 'const', -2.0]])
    w1 = seeded_weights(shapes, 2 ** 32 + 3, 'cpu', init)
    w2 = seeded_weights(shapes, 2 ** 32 + 3, 'cpu', init)
    for k in w1:
        assert torch.equal(w1[k], w2[k])
    assert abs(float(w1['a.weight'].std()) - 0.5 / (32 * 9) ** 0.5) < 3e-3
    assert torch.equal(w1['a.bias'], torch.zeros(64))
    assert torch.equal(w1['n.weight'], torch.ones(32))
    assert torch.equal(w1['cls.bias'], torch.full((4,), -2.0))


def _cost(op):
    return kernels.load_cost(op)


def test_pairwise_live_counts_by_hand():
    import torch
    live = kernels.load_file('pairwise_live')
    assert sorted(live.stencil(3, 2)) == sorted(
        [(-2, -2), (-2, 0), (-2, 2), (0, -2), (0, 2), (2, -2), (2, 0),
         (2, 2)])
    bm = torch.zeros(1, 3, 5, 7)
    bm[0, 0, 2, 3] = 1          # all 8 neighbours inside the map: 9
    bm[0, 1, 0, 0] = 1          # a corner: (0, 2), (2, 0), (2, 2): 4
    bm[0, 2, 2, 3] = 1          # invalid: nothing
    valid = torch.tensor([[True, True, False]])
    c = live.counts(bm, valid, 3, 2)
    assert c == dict(shape=[1, 3, 5, 7], weighted=2, near=13)
    # two weighted pixels two apart share their neighbours: a 3x5 block of
    # them at even offsets (1 and 5 columns, rows 1 and 3)
    bm = torch.zeros(1, 1, 5, 7)
    bm[0, 0, 2, 2] = bm[0, 0, 2, 4] = 1
    c = live.counts(bm, torch.tensor([[True]]), 3, 2)
    assert c['weighted'] == 2
    assert c['near'] == 3 * 4          # rows 0, 2, 4 x columns 0, 2, 4, 6


def test_pairwise_counts_by_hand():
    # (2, 64, 200, 336) logits, 8 offsets, at the live bound: operations on
    # the weighted items (K1 90 each, K2 120), the logits near a weight
    # read once, the bitmasks whole (K1) or near a weight (K2), the gates
    # and flags once; K1 writes its sums and the live map, K2 the gradient
    live = dict(shape=[2, 64, 200, 336], weighted=1000, near=3000)
    shp = [[2, 64, 200, 336], [2, 8, 200, 336], [2, 64, 200, 336], [2, 64],
           [], [], []]
    dt = ['float', 'float', 'float', 'bool', 'double', 'long int',
          'long int']
    n = 2 * 64 * 200 * 336
    sim = 4 * 2 * 8 * 200 * 336
    tiles = 2 * 64 * 25 * 11
    ops, nbytes = _cost('boxinstseg::pairwise_forward')(shp, dt, live)
    assert ops == 90 * 1000
    assert nbytes == 4 * n + sim + 128 + 4 * 3000 + 8 + tiles
    shp2 = shp[:4] + [[1], [tiles]] + [[], [], []]
    dt2 = dt[:4] + ['float', 'unsigned char'] + dt[4:]
    ops2, nbytes2 = _cost('boxinstseg::pairwise_backward')(shp2, dt2, live)
    assert ops2 == 120 * 1000
    assert nbytes2 == sim + 128 + 4 + tiles + 8 * 3000 + 4 * n
    # counts of another call's shape are refused
    other = dict(live, shape=[2, 64, 336, 200])
    assert _cost('boxinstseg::pairwise_forward')(shp, dt, other) is None


def test_roofline_needs_every_calls_counts():
    shp = [[1, 2, 8, 32], [1, 8, 8, 32], [1, 2, 8, 32], [1, 2], [], [], []]
    dt = ['float', 'float', 'float', 'bool', 'double', 'long int',
          'long int']
    op = 'boxinstseg::pairwise_forward'
    live = dict(shape=[1, 2, 8, 32], weighted=10, near=30)
    rec = dict(op_device_s={op: 1e-5}, op_calls={op: [(shp, dt)] * 2},
               op_inputs={op: [live, live]})
    nbytes = 4 * 8 * 8 * 32 + 4 * 2 * 8 * 32 + 2 + 4 * 30 + 8 + 2
    want = 100 * 2 * max(90 * 10 / 67e12, nbytes / 3.35e12) / 1e-5
    assert kernels.roofline_percent(rec, [op]) == pytest.approx(want)
    assert kernels.roofline_percent(dict(rec, op_inputs={op: [live]}),
                                    [op]) is None
    assert kernels.roofline_percent(dict(rec, op_inputs={}), [op]) is None


def test_reference_counts_equal_the_programs_inputs():
    """The counts the reference's pass records for the traced batches equal
    those of the bitmasks and flags that the program hands K1 at the same
    batches, after its own updates (the sampled GTs follow from the FCOS
    targets, not from the weights)."""
    import torch
    sys.path.insert(0, HERE)
    import pb_tiny as tiny
    from harness import train
    import boxinstseg_tpu_torch.ops.pairwise as pw
    live = kernels.load_file('pairwise_live')
    torch.set_num_threads(1)
    seen = []
    inner = pw.pairwise_forward_op

    def recorded(x, sim, bm, valid, thresh, ks, dil):
        seen.append(live.counts(bm, valid, ks, dil))
        return inner(x, sim, bm, valid, thresh, ks, dil)

    c = tiny.ctx(tiny.tiny_boxinst(),
                 tiny.tiny_train_mix('boxinst_multiscale'), trace=1)
    pw.pairwise_forward_op = recorded
    try:
        out = train.run(c, 'cpu')
    finally:
        pw.pairwise_forward_op = inner
    got = train.yardstick(c, out, 'cpu')['op_inputs']
    n = len(out['attributed_batches'])
    assert n == c['mix']['trace_steps']
    assert got['boxinstseg::pairwise_forward'] == seen[-n:]
    assert got['boxinstseg::pairwise_backward'] == seen[-n:]
    assert all(s['weighted'] > 0 for s in seen)


def test_msda_counts_by_hand():
    # one Box2Mask encoder layer: B 2, 8 heads, D 32, 3 levels, 4 points
    s = 128 * 128 + 64 * 64 + 32 * 32
    shp = [[2, s, 8, 32], [], [2, s, 2], [2, s, 8, 3, 4, 2],
           [2, s, 8, 3, 4]]
    dt = ['float', 'GenericList', 'float', 'float', 'float']
    samples = 2 * s * 8 * 3 * 4
    ops, nbytes = _cost('boxinstseg::msda_forward')(shp, dt)
    assert ops == 8 * samples * 32
    assert nbytes == 4 * (2 * s * 256 + 2 * s * 2 + 2 * samples + samples) \
        + 4 * 2 * s * 256
    ops_b, bytes_b = _cost('boxinstseg::msda_backward')(
        shp + [[2, s, 256]], dt + ['float'])
    assert ops_b == 16 * samples * 32
    assert bytes_b == nbytes - 4 * 2 * s * 256 + 4 * 2 * s * 256 \
        + 4 * (2 * s * 256 + 2 * samples + samples)


def test_roofline_share():
    rec = dict(op_device_s={'boxinstseg::msda_forward': 2e-4},
               op_calls={'boxinstseg::msda_forward': [
                   ([[1, 100, 1, 4], [], [1, 10, 2], [1, 10, 1, 1, 1, 2],
                     [1, 10, 1, 1, 1]],
                    ['float', 'GenericList', 'float', 'float', 'float'])]})
    nbytes = 4 * (400 + 20 + 20 + 10) + 4 * 40
    want = 100 * max(8 * 10 * 4 / 67e12, nbytes / 3.35e12) / 2e-4
    got = kernels.roofline_percent(rec, ['boxinstseg::msda_forward'])
    assert got == pytest.approx(want, rel=1e-12)
    assert kernels.roofline_percent(rec, ['boxinstseg::other']) is None


def test_busy_union_by_hand():
    assert trace.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert trace.device_busy(trace.device_profiler(False)) == 0.0
    assert trace.union_length([]) == 0
    assert trace.merged([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]


def test_quantile_is_numpy_linear():
    xs = list(np.random.default_rng(0).random(101))
    for q in (0.5, 0.9, 0.95):
        assert p_quantile(xs, q) == pytest.approx(np.quantile(xs, q))


FORBIDDEN = {'jax', 'jaxlib', 'flax', 'boxinstseg_tpu'}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split('.')[0]


def _py_files(top):
    for root, _, files in os.walk(top):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(root, f)


def test_nothing_imports_jax_or_the_jax_package():
    seen = {p: set(_imports(p)) & FORBIDDEN for p in _py_files(PB)}
    assert not {p: s for p, s in seen.items() if s}


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(PB, 'reference')
    seen = {p: {m for m in _imports(p)
                if m in FORBIDDEN | {'boxinstseg_tpu_torch'}}
            for p in _py_files(ref)}
    assert not {p: s for p, s in seen.items() if s}


def _dets(masks, scores, labels, boxes=None):
    masks = np.asarray(masks, np.uint8)
    if boxes is None:
        boxes = np.zeros((len(masks), 4))
        for k, m in enumerate(masks):
            ys, xs = np.nonzero(m)
            boxes[k] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
    return dict(bboxes=np.concatenate([boxes, np.asarray(scores)[:, None]],
                                      1),
                labels=np.asarray(labels), masks=list(masks))


def _ref(d):
    import torch
    return dict(scores=d['bboxes'][:, 4], labels=d['labels'],
                boxes=d['bboxes'][:, :4],
                masks=torch.from_numpy(np.stack(d['masks'])).bool())


def _blocks(n, size=24):
    """n distinct square masks on a size x size map."""
    masks = np.zeros((n, size, size), np.uint8)
    for k in range(n):
        y, x = divmod(k, 5)
        masks[k, 4 * y:4 * y + 3, 4 * x:4 * x + 3 + k % 2] = 1
    return masks


def test_predict_gaps_match_one_to_one():
    from reference import compare
    n = 20
    masks = _blocks(n)
    scores = np.linspace(0.9, 0.3, n)
    labels = np.arange(n) % 3
    ref = _ref(_dets(masks, scores, labels))
    # the same detections in another order read 0
    perm = np.random.default_rng(0).permutation(n)
    same = compare.predict_gaps(_dets(masks[perm], scores[perm],
                                      labels[perm]), ref, 'cpu')
    assert same['mask_box_gap'] == same['score_gap'] == 0
    # three copies of the best detection in place of three others: each
    # copy can take only one reference detection, so two read far off
    dup = _dets(masks, scores, labels)
    for i in (1, 2, 3):
        dup['masks'][i] = dup['masks'][0].copy()
        dup['bboxes'][i] = dup['bboxes'][0]
        dup['labels'][i] = dup['labels'][0]
    gaps = compare.predict_gaps(dup, ref, 'cpu')
    assert gaps['mask_box_gap'] > 0.5
    assert gaps['worst_mask_box_gap'] == 1.0
    # a few boxes moved, masks and scores untouched
    moved = _dets(masks, scores, labels)
    moved['bboxes'][:3, :4] += 2.0
    gaps = compare.predict_gaps(moved, ref, 'cpu')
    assert gaps['score_gap'] == 0 and gaps['worst_box_gap'] > 0.1
    assert gaps['mask_box_gap'] > 0.1
    # a detection whose label the reference lacks reads 1
    other = _dets(masks, scores, np.where(np.arange(n) < 3, 7, labels))
    assert compare.predict_gaps(other, ref, 'cpu')['worst_score_gap'] == 1.0
