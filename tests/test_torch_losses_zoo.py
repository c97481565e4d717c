"""The port's loss zoo (``models/losses/{misc_losses,seesaw_loss,
pisa_loss,ae_loss}.py``), the softmax ``CrossEntropyLoss`` and the IoU
family against the JAX package's, on the CPU: the same seeded numpy
inputs, each loss and the gradient of its input within atol 1e-5 /
rtol 1e-4 (accuracy's percentages and Seesaw's counters exactly).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

import boxinstseg_tpu.models.losses as JL
from boxinstseg_tpu.registry import LOSSES as J_LOSSES

import boxinstseg_tpu_torch.models.losses as TL
from boxinstseg_tpu_torch.registry import LOSSES

ATOL, RTOL = 1e-5, 1e-4


def close(got, want, exact=False):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def value_and_grad(jfn, tfn, x, *rest):
    """The loss and d(loss)/dx of both packages at numpy x; ``rest`` are
    the other inputs (numpy, or tuples of numpy)."""
    def to_j(a):
        return tuple(map(to_j, a)) if isinstance(a, tuple) \
            else jnp.asarray(a)

    def to_t(a):
        return tuple(map(to_t, a)) if isinstance(a, tuple) \
            else torch.from_numpy(np.array(a))
    jv, jg = jax.value_and_grad(lambda v: jfn(v, *map(to_j, rest)))(
        jnp.asarray(x))
    xt = torch.from_numpy(np.array(x)).requires_grad_()
    tv = tfn(xt, *map(to_t, rest))
    tv.backward()
    close(tv, jv)
    close(xt.grad, jg)
    return float(tv.detach())


def boxes(rng, n, jitter=None):
    xy = rng.rand(n, 2) * 50
    wh = rng.rand(n, 2) * 30 + 2
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    if jitter is not None:
        b = b + (rng.randn(n, 4) * jitter).astype(np.float32)
    return b


# (registry name, config, kind of inputs)
ELEMENTWISE = {
    'L1Loss': dict(), 'MSELoss': dict(reduction='sum'),
    'SmoothL1Loss': dict(beta=0.5),
    'BalancedL1Loss': dict(alpha=0.5, gamma=1.5, beta=1.0),
}


@pytest.mark.parametrize('name', sorted(ELEMENTWISE))
@pytest.mark.parametrize('weighted', [False, True])
def test_regression_losses_equal_jax(name, weighted):
    rng = np.random.RandomState(0)
    pred = rng.randn(40, 4).astype(np.float32)
    target = (pred + rng.randn(40, 4) * 0.8).astype(np.float32)
    cfg = dict(type=name, **ELEMENTWISE[name])
    jl, tl = J_LOSSES.build(dict(cfg)), LOSSES.build(dict(cfg))
    if weighted:
        w = rng.rand(40, 4).astype(np.float32)
        value_and_grad(lambda p, t, w: jl(p, t, w, avg_factor=7.0),
                       lambda p, t, w: tl(p, t, w, avg_factor=7.0),
                       pred, target, w)
    else:
        value_and_grad(jl, tl, pred, target)


def test_classification_losses_equal_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(30, 6).astype(np.float32)
    prob = (1 / (1 + np.exp(-logits))).astype(np.float32)
    heat = rng.rand(30, 6).astype(np.float32)
    heat[::4, 2] = 1.0
    jl, tl = (J_LOSSES.build(dict(type='GaussianFocalLoss')),
              LOSSES.build(dict(type='GaussianFocalLoss')))
    value_and_grad(jl, tl, prob, heat)
    iou_t = np.where(rng.rand(30, 6) > 0.7, rng.rand(30, 6), 0.0).astype(
        np.float32)
    for weighted in (True, False):
        cfg = dict(type='VarifocalLoss', iou_weighted=weighted)
        value_and_grad(J_LOSSES.build(dict(cfg)), LOSSES.build(dict(cfg)),
                       logits, iou_t)
    label = rng.randint(0, 7, 30).astype(np.int32)       # 6 = background
    score = rng.rand(30).astype(np.float32)
    cfg = dict(type='QualityFocalLoss', beta=2.0)
    value_and_grad(lambda p, lab, s: J_LOSSES.build(dict(cfg))(p, (lab, s)),
                   lambda p, lab, s: LOSSES.build(dict(cfg))(p, (lab, s)),
                   logits, label, score)
    dist = rng.randn(30, 9).astype(np.float32)
    cont = (rng.rand(30) * 7.99).astype(np.float32)
    value_and_grad(J_LOSSES.build(dict(type='DistributionFocalLoss')),
                   LOSSES.build(dict(type='DistributionFocalLoss')),
                   dist, cont)
    soft = rng.randn(30, 6).astype(np.float32)
    cfg = dict(type='KnowledgeDistillationKLDivLoss', T=4)
    value_and_grad(J_LOSSES.build(dict(cfg)), LOSSES.build(dict(cfg)),
                   logits, soft)


def test_ghm_losses_equal_jax():
    rng = np.random.RandomState(2)
    logits = (rng.randn(50, 4) * 2).astype(np.float32)
    target = (rng.rand(50, 4) > 0.7).astype(np.float32)
    lw = (rng.rand(50, 4) > 0.1).astype(np.float32)
    value_and_grad(J_LOSSES.build(dict(type='GHMC', bins=10)),
                   LOSSES.build(dict(type='GHMC', bins=10)),
                   logits, target, lw)
    pred = rng.randn(50, 4).astype(np.float32)
    tgt = (pred + rng.randn(50, 4) * 0.05).astype(np.float32)
    value_and_grad(J_LOSSES.build(dict(type='GHMR', mu=0.02, bins=10)),
                   LOSSES.build(dict(type='GHMR', mu=0.02, bins=10)),
                   pred, tgt, lw)


@pytest.mark.parametrize('topk, thresh', [(1, None), ((1, 3), None),
                                          ((1, 2), 0.2)])
def test_accuracy_equals_jax(topk, thresh):
    rng = np.random.RandomState(3)
    pred = rng.randint(0, 4, (64, 7)).astype(np.float32) / 4  # many ties
    target = rng.randint(0, 7, 64).astype(np.int32)
    want = JL.Accuracy(topk, thresh)(jnp.asarray(pred), jnp.asarray(target))
    got = TL.Accuracy(topk, thresh)(torch.from_numpy(pred),
                                    torch.from_numpy(target).long())
    for a, b in zip(*[x if isinstance(x, (list, tuple)) else [x]
                      for x in (got, want)]):
        close(a, b, exact=True)


@pytest.mark.parametrize('class_weight', [None, [1.0, 2.0, 0.5, 1.0, 3.0]])
@pytest.mark.parametrize('reduce', ['mean', 'weight', 'avg_factor'])
def test_softmax_cross_entropy_equals_jax(class_weight, reduce):
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 20, 5).astype(np.float32)
    labels = rng.randint(0, 5, (3, 20)).astype(np.int32)
    w = rng.rand(3, 20).astype(np.float32)
    cfg = dict(type='CrossEntropyLoss', use_sigmoid=False,
               class_weight=class_weight, loss_weight=0.7)
    jl, tl = J_LOSSES.build(dict(cfg)), LOSSES.build(dict(cfg))
    kw = dict(avg_factor=11.0) if reduce == 'avg_factor' else {}
    if reduce == 'mean':
        value_and_grad(lambda x, y: jl(x, y, **kw),
                       lambda x, y: tl(x, y.long(), **kw), logits, labels)
    else:
        value_and_grad(lambda x, y, w: jl(x, y, w, **kw),
                       lambda x, y, w: tl(x, y.long(), w, **kw),
                       logits, labels, w)


IOU = {
    'IoULoss': dict(), 'IoULoss-linear': dict(linear=True),
    'IoULoss-square': dict(mode='square'), 'GIoULoss': dict(),
    'DIoULoss': dict(), 'CIoULoss': dict(), 'BoundedIoULoss': dict(beta=0.2),
}


@pytest.mark.parametrize('name', sorted(IOU))
def test_iou_losses_equal_jax(name):
    rng = np.random.RandomState(5)
    target = boxes(rng, 32)
    pred = target + (rng.randn(32, 4) * 4).astype(np.float32)
    pred[3] = target[3] + 0.3              # IoU > 0.5 (CIoU's gate)
    cfg = dict(type=name.split('-')[0], **IOU[name])
    jl, tl = J_LOSSES.build(dict(cfg)), LOSSES.build(dict(cfg))
    # a weight a box; DIoU and CIoU average a (N, 4) one, BoundedIoU takes
    # one a coordinate
    per_coord = cfg['type'] in ('DIoULoss', 'CIoULoss', 'BoundedIoULoss')
    w = rng.rand(*((32, 4) if per_coord else (32,))).astype(np.float32)
    value_and_grad(lambda p, t, w: jl(p, t, w, avg_factor=9.0),
                   lambda p, t, w: tl(p, t, w, avg_factor=9.0),
                   pred, target, w)


def test_seesaw_loss_and_its_counter_equal_jax():
    rng = np.random.RandomState(6)
    c, n = 12, 40
    jl = J_LOSSES.build(dict(type='SeesawLoss', num_classes=c))
    tl = LOSSES.build(dict(type='SeesawLoss', num_classes=c))
    labels = rng.randint(0, c + 1, n).astype(np.int32)
    labels[:25] = rng.randint(0, 3, 25)             # a long tail
    jcum = jl.init_cum_samples()
    tcum = tl.init_cum_samples(device='cpu')
    for step in range(2):
        jcum = jl.update_cum_samples(jcum, jnp.asarray(labels))
        tcum = tl.update_cum_samples(tcum, torch.from_numpy(labels))
        close(tcum, jcum, exact=True)
        score = rng.randn(n, c + 2).astype(np.float32)
        lw = rng.rand(n).astype(np.float32)
        for key in ('loss_cls_objectness', 'loss_cls_classes'):
            value_and_grad(
                lambda s, lab, w, cum: jl(s, lab, cum, w)[key],
                lambda s, lab, w, cum: tl(s, lab.long(), cum, w)[key],
                score, labels, lw, np.asarray(jcum))
        close(tl.get_activation(torch.from_numpy(score)),
              jl.get_activation(jnp.asarray(score)))
    valid = rng.rand(n) > 0.5
    close(tl.update_cum_samples(tcum, torch.from_numpy(labels),
                                torch.from_numpy(valid)),
          jl.update_cum_samples(jcum, jnp.asarray(labels),
                                jnp.asarray(valid)), exact=True)


def test_pisa_losses_equal_jax():
    rng = np.random.RandomState(7)
    n, c = 24, 4
    labels = rng.randint(0, c + 1, n).astype(np.int32)
    cls = rng.randn(n, c).astype(np.float32)
    bbox_pred = (rng.randn(n, 4) * 0.1).astype(np.float32)
    bbox_t = (rng.randn(n, 4) * 0.1).astype(np.float32)
    for sigmoid in (False, True):
        value_and_grad(
            lambda s, lab, p, t: JL.carl_loss(
                s, lab, p, t, lambda a, b: jnp.abs(a - b), sigmoid=sigmoid,
                num_class=c)['loss_carl'],
            lambda s, lab, p, t: TL.carl_loss(
                s, lab, p, t, lambda a, b: (a - b).abs(), sigmoid=sigmoid,
                num_class=c)['loss_carl'],
            cls, labels, bbox_pred, bbox_t)
    rois = boxes(rng, n)
    gts = np.where(labels < c, rng.randint(0, 3, n), 0).astype(np.int32)
    class_pred = (rng.randn(n, 4 * c) * 0.1).astype(np.float32)

    def j_ce(s, lab, reduction_override='none'):
        return -jax.nn.log_softmax(s, axis=-1)[jnp.arange(s.shape[0]), lab]

    def t_ce(s, lab, reduction_override='none'):
        return F.cross_entropy(s, lab, reduction='none')
    for pred in (bbox_pred, class_pred):
        for k, bias in ((2.0, 0.0), (1.0, 0.3)):
            want = JL.isr_p(jnp.asarray(cls), jnp.asarray(pred),
                            (jnp.asarray(labels), jnp.ones(n),
                             jnp.asarray(bbox_t), jnp.ones((n, 4))),
                            jnp.asarray(rois), jnp.asarray(gts), j_ce,
                            lambda r, d: r + d, k=k, bias=bias,
                            num_class=c)
            got = TL.isr_p(torch.from_numpy(cls), torch.from_numpy(pred),
                           (torch.from_numpy(labels), torch.ones(n),
                            torch.from_numpy(bbox_t), torch.ones(n, 4)),
                           torch.from_numpy(rois), torch.from_numpy(gts),
                           t_ce, lambda r, d: r + d, k=k, bias=bias,
                           num_class=c)
            for a, b in zip(got, want):
                close(a, b)


def test_ae_loss_equals_jax():
    rng = np.random.RandomState(8)
    b, h, w, ch, k = 2, 9, 11, 2, 5
    tl_e = rng.randn(b, h, w, ch).astype(np.float32)
    br_e = rng.randn(b, h, w, ch).astype(np.float32)
    ys, xs = rng.randint(0, h, (b, k, 2)), rng.randint(0, w, (b, k, 2))
    match = np.stack([ys, xs], -1).astype(np.int32)  # [[tl_y, tl_x], [br..]]
    valid = rng.rand(b, k) > 0.3
    valid[1] = False
    valid[1, 0] = True                     # one object: no push pairs
    jl = JL.AssociativeEmbeddingLoss(0.25, 0.25)
    tl = TL.AssociativeEmbeddingLoss(0.25, 0.25)
    for i in range(2):
        value_and_grad(lambda x, y, m, v: jl(x, y, m, v)[i],
                       lambda x, y, m, v: tl(x, y, m, v)[i],
                       tl_e, br_e, match, valid)
