"""The shipped configs (``configs/``) in the port against the JAX package,
on the CPU: the checks that ``tests/test_torch_configs_{boxinst,
boxlevelset,discobox,box2mask}.py`` run on each config of their family, and
the small-size parity harness of their per-family models.

- ``check_architecture``: the JAX detector built from the config, its
  variables' shapes taken by ``jax.eval_shape`` of its init on a small
  image (tracing only; 384x384 for Swin, where no stage's map is smaller
  than its window), each leaf filled with one value of a seeded
  permutation, converted by ``params_from_jax`` and loaded with
  ``strict=True`` into the port's detector built from the same config on
  the meta device (no weights allocated): every name and shape, every JAX
  leaf somewhere in the port and no port tensor from anywhere else, the
  same parameter count. A VOC config also names ``PascalVOCDataset``'s 20
  classes, in both packages alike, and a Box2Mask one a ``class_weight``
  of num_classes + 1.
- ``check_param_groups``: every parameter's (lr_mult, decay_mult) in the
  port's ``param_groups`` equals the JAX ``paramwise_fns`` on the JAX path
  of the same tensor.
- ``check_schedule``: the port's ``train_schedule`` against the JAX
  ``resolve_intervals`` and ``build_lr_schedule`` at iterations 0 and 1,
  around the end of the warm-up, at each step boundary and one either
  side, and at the last iteration, for the recipe's 8 cards on COCO
  train2017 or VOC 2012 train-aug: within two float32 units in the last
  place of the base LR of the JAX schedule (which computes in float32),
  and within 1e-12 relative of mmcv's step schedule in float64.
- ``check_loss_parity``: a small model of a family (a few layers, narrow
  widths, 128x128 images from a numpy seed) in both packages with the same
  weights: its forward outputs, loss dict and the gradient of every
  parameter at atol 1e-5 (gradients: 1e-5 of their largest entry, 1e-5 at
  least) / rtol 1e-4.
"""
import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boxinstseg_tpu.apis.train import resolve_intervals as j_resolve
from boxinstseg_tpu.config import Config as JConfig
from boxinstseg_tpu.engine import init_variables
from boxinstseg_tpu.data.coco import PascalVOCDataset as JVOC
from boxinstseg_tpu.engine.schedules import build_lr_schedule as j_schedule
from boxinstseg_tpu.registry import build_detector as j_build
from test_torch_box2mask import _jax_leaf_multipliers, _port_leaf_multipliers

from boxinstseg_tpu_torch.apis.train import train_schedule
from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.data.coco import PascalVOCDataset
from boxinstseg_tpu_torch.engine.optimizers import param_groups
from boxinstseg_tpu_torch.registry import build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-5, 1e-4
LR_RTOL = 1e-12
CARDS = 8                             # the recipes' GPUs
TRAIN_IMAGES = {'coco': 117266, 'voc': 10582}   # train2017, train-aug


def shipped(family):
    """The family's shipped config files, sorted."""
    return sorted(glob.glob(os.path.join(ROOT, 'configs', family, '*.py')))


def config_ids(paths):
    return [os.path.basename(p)[:-3] for p in paths]


def jax_variables(path):
    """The JAX detector's variables as shapes (traced, not run; once for
    the configs of one model, such as a recipe's 1x and 3x)."""
    cfg = JConfig.fromfile(path).model
    key = repr(cfg)
    if key not in _TRACED:
        side = 384 if cfg.backbone.type == 'SwinTransformer' else 128
        jm = j_build(cfg)
        x = jnp.zeros((1, side, side, 3), jnp.float32)
        _TRACED[key] = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                      x))
    return _TRACED[key]


_TRACED = {}


def _values(t):
    """The distinct values of a float tensor (one where it is constant)."""
    lo, hi = t.min().item(), t.max().item()
    return {lo} if lo == hi else set(np.unique(t.numpy()).tolist())


def check_architecture(path):
    shapes = jax_variables(path)
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    fill = np.random.RandomState(0).permutation(len(leaves)) + 1.0
    filled = jax.tree_util.tree_unflatten(treedef, [
        np.broadcast_to(np.float32(x), s.shape)
        for x, s in zip(fill, leaves)])
    sd = params_from_jax(filled['params'], filled.get('batch_stats', {}))
    cfg = Config.fromfile(path)
    with torch.device('meta'):
        tm = build_detector(cfg.model)
    tm.load_state_dict(sd, strict=True, assign=True)
    seen = set()
    for name, t in tm.state_dict().items():
        if t.is_floating_point():
            got = _values(t)
            assert got <= set(fill), name
            seen |= got
    assert seen == set(fill)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
            shapes['params']))
    if cfg.data.train.type == 'PascalVOCDataset':
        assert PascalVOCDataset.CLASSES == JVOC.CLASSES
        assert len(PascalVOCDataset.CLASSES) == 20
        head = cfg.model.get('panoptic_head') or cfg.model.bbox_head
        classes = head.get('num_things_classes', head.get('num_classes'))
        assert classes == 20
        weight = head.get('loss_cls', {}).get('class_weight')
        if 'panoptic_head' in cfg.model:
            assert weight == [1.0] * classes + [0.1]
    return tm


def check_param_groups(path):
    cfg = Config.fromfile(path)
    opt = dict(cfg.optimizer)
    want = _jax_leaf_multipliers(opt, jax_variables(path)['params'])
    with torch.device('meta'):
        model = build_detector(cfg.model)
    _, owner = _port_leaf_multipliers(opt, model)
    names = {id(p): n for n, p in model.named_parameters()}
    lr, wd = float(opt['lr']), float(opt['weight_decay'])
    table = {}
    for g in param_groups(opt, model.named_parameters()):
        assert g['lr'] == pytest.approx(lr * g['lr_mult'], rel=LR_RTOL)
        for p in g['params']:
            table[names[id(p)]] = (g['lr_mult'], g['weight_decay'] / wd)
    assert set(table) == set(names.values()) == set(owner.values())
    assert set(owner) == set(want)
    for jpath, mults in want.items():
        assert table[owner[jpath]] == pytest.approx(mults, rel=LR_RTOL), \
            (jpath, owner[jpath])
    return set(want.values())


def _boundaries(lr_cfg, iv, iters_per_epoch):
    """The schedule's step boundaries in iterations (none for a policy
    without steps)."""
    steps = lr_cfg.get('step', [])
    steps = [steps] if isinstance(steps, int) else list(steps)
    return [s * (iters_per_epoch if iv['lr_by_epoch'] else 1)
            for s in steps]


def _mmcv_step_lr(lr_cfg, base_lr, i, bounds):
    """mmcv's ``StepLrUpdaterHook`` with its linear warm-up at iteration
    ``i``, in float64: base * gamma^(boundaries passed), times 1 - (1 -
    i / warmup_iters) (1 - warmup_ratio) during the warm-up."""
    lr = base_lr * lr_cfg.get('gamma', 0.1) ** sum(i >= b for b in bounds)
    warm = lr_cfg.get('warmup_iters', 0)
    if lr_cfg.get('warmup') == 'linear' and i < warm:
        lr *= 1 - (1 - i / warm) * (1 - lr_cfg.get('warmup_ratio', 0.1))
    return lr


def check_schedule(path):
    """The port's LR against the JAX schedule, and against mmcv's step
    schedule in float64 (every shipped config has the step policy with a
    linear warm-up). The JAX step schedule computes in float32 even under
    ``jax.enable_x64`` (``boxinstseg_tpu/engine/schedules.py``
    ``step_lr_schedule``: its count, steps and LR are ``jnp.float32``), so
    the port, in float64, is held to it within two float32 units in the
    last place of the base LR (2^-22 x base LR: the rounding of its warm-up
    factor and product), and to mmcv's formula within 1e-12 relative."""
    cfg, jcfg = Config.fromfile(path), JConfig.fromfile(path)
    dataset = 'voc' if cfg.data.train.type == 'PascalVOCDataset' else 'coco'
    lr_fn, base_lr, ipe, iv = train_schedule(
        cfg, cfg.data.samples_per_gpu * CARDS, TRAIN_IMAGES[dataset])
    j_iv = j_resolve(jcfg, ipe)
    assert {k: iv[k] for k in j_iv} == j_iv
    lr_cfg = jcfg.get('lr_config', {})
    assert lr_cfg.get('policy', 'step') == 'step'
    last = iv['max_iters'] - 1
    warm = lr_cfg.get('warmup_iters', 0) if lr_cfg.get('warmup') else 0
    points = {0, 1, last}
    if warm:
        points |= {warm - 1, warm, warm + 1}
    bounds = _boundaries(lr_cfg, iv, ipe)
    for b in bounds:
        points |= {b - 1, b, b + 1}
    points = sorted(i for i in points if 0 <= i <= last)
    got = [lr_fn(i) for i in points]
    np.testing.assert_allclose(got, [_mmcv_step_lr(lr_cfg, base_lr, i,
                                                   bounds) for i in points],
                               rtol=LR_RTOL, atol=0)
    with jax.enable_x64(True):
        want = j_schedule(lr_cfg, base_lr, ipe, by_epoch=j_iv['lr_by_epoch'],
                          max_iters=j_iv['max_iters'])
        np.testing.assert_allclose(got, [float(want(i)) for i in points],
                                   rtol=0, atol=2.0 ** -22 * base_lr)
    for b in bounds:                     # each boundary steps the LR down
        assert lr_fn(b + 1) < lr_fn(b - 1), b
    return dict(zip(points, got))


# ---------------------------------------------------- small-size parity

def to_torch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out['image'] = out['image'].permute(0, 3, 1, 2).contiguous()
    return out


def _leaves(tree):
    """A forward output's arrays in a fixed order: dict entries by key,
    sequences in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def close_scaled(got, want, what):
    ref = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=ATOL * max(ref, 1.0),
                               rtol=RTOL, err_msg=what)


def check_loss_parity(cfg, batch, jax_loss_args=(), torch_loss_args=(),
                      scale_kernel=None, prepare=None, grads_out=None):
    """``cfg``: a small model dict of either package's registry; ``batch``:
    numpy NHWC. The JAX init of the forward (seed 0; ``scale_kernel``
    multiplies the SOLO kernel branch's last conv, as the family's tests do, so that no mask
    score sits at a threshold) loaded into the port; ``prepare(jm,
    variables, jax_batch, port_model)``, if given, runs before the port's
    forward; the forward in training mode, the loss dict and every
    gradient compared. Returns the loss dict; a ``grads_out`` dict gets the
    JAX gradients by the port's names, the port's model and batch."""
    jm = j_build(cfg)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)}, jb['image'])
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    if scale_kernel is not None:
        head = v['params']['bbox_head_m']
        head['solo_kernel'] = dict(head['solo_kernel'],
                                   kernel=head['solo_kernel']['kernel']
                                   * scale_kernel)
    rest = {k: x for k, x in v.items() if k != 'params'}

    def total(params, b):
        variables = {'params': params, **rest}
        losses = dict(jm.apply(variables, b, jnp.zeros((), jnp.int32),
                               *jax_loss_args, method=jm.loss))
        losses.pop('_corr_append', None)
        outs = jm.apply(variables, b['image'], True)
        return sum(x for k, x in losses.items() if 'loss' in k), (losses,
                                                                  outs)

    (_, (want, forward)), grads = jax.jit(jax.value_and_grad(
        total, has_aux=True))(v['params'], jb)
    tm = build_detector(cfg)
    tm.load_state_dict(params_from_jax(v['params'], v.get('batch_stats')),
                       strict=True)
    tm.train()
    if prepare is not None:
        prepare(jm, v, jb, tm)
    tb = to_torch(batch)
    with torch.no_grad():
        got_f = tm(tb['image'])
    jl, tl = _leaves(jax.device_get(forward)), _leaves(got_f)
    assert len(jl) == len(tl) > 0
    for i, (w, g) in enumerate(zip(jl, tl)):
        w, g = np.asarray(w), g.numpy()
        # the port's NCHW maps against the JAX package's NHWC ones; a map
        # whose shape reads the same both ways is held in either
        ways = [g, g.transpose(0, 2, 3, 1)] if g.ndim == 4 else [g]
        ways = [x for x in ways if x.shape == w.shape]
        assert ways, (i, g.shape, w.shape)
        for j, x in enumerate(ways):
            try:
                close_scaled(x, w, f'forward output {i}')
                break
            except AssertionError:
                if j == len(ways) - 1:
                    raise
    got = dict(tm.loss(tb, 0, *torch_loss_args))
    got.pop('_corr_append', None)
    assert set(got) == set(want)
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), rel=RTOL,
                                              abs=ATOL), k
    sum(x for k, x in got.items() if 'loss' in k).backward()
    jg = params_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                         v.get('batch_stats'))
    if grads_out is not None:
        grads_out.update(grads=jg, model=tm, batch=tb)
    moved = 0
    for k, p in tm.named_parameters():
        w = jg[k].numpy()
        if p.grad is None:                       # a frozen stage
            assert not w.any(), k
            continue
        close_scaled(p.grad.numpy(), w, k)
        moved += bool(w.any())
    assert moved > len(list(tm.parameters())) // 2
    return {k: float(x) for k, x in want.items()}
