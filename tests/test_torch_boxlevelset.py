"""The port's BoxLevelset slice against the JAX package, on the CPU.

A tiny BoxLevelSet (ResNet-18, a 32-channel FPN, grids 12/10/8/6/4,
``max_pos=8``, ``tf_size=(24, 24)``: the ``tiny_cfg`` of
``tests/test_boxlevelset_model.py``) with the same weights (JAX init
converted by ``params_from_jax``; the kernel branch's last conv scaled by
1000 in both packages, so that the mask scores spread over 0.3-0.7
instead of lying within 1e-3 of 0.5) and the same
seeded batch:

- (a) the head's forward outputs: atol 1e-5 / rtol 1e-4;
- (b) the loss dict with the tree depth uncapped (``tf_max_depth=0``) and
  binding (64): rtol 1e-4;
- (c) every parameter's gradient (rtol 1e-4, atol 1e-6), then one AdamW
  step of the shipped recipe's optimizer (paramwise ``norm_decay_mult=0``,
  grad clip 1) against ``make_train_step``: logs and every parameter;
- (d) ``get_seg``: validity and labels exactly, scores and masks on valid
  slots;
- (e) ``params_from_jax`` round-trips through ``convert_reference_checkpoint``;
- the shipped config's ``loss_boxpro`` and ``loss_levelset`` build by name
  in both packages and agree;
- the shipped R-50 3x config builds in the port at full width.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.engine import (build_lr_schedule as j_schedule,
                                   build_optimizer as j_optimizer,
                                   create_train_state, init_variables,
                                   make_train_step as j_train_step)
from boxinstseg_tpu.registry import LOSSES as J_LOSSES
from boxinstseg_tpu.registry import build_detector as j_build
from boxinstseg_tpu.utils.checkpoint_convert import \
    convert_reference_checkpoint
from test_boxlevelset_model import H, W, synth_batch, tiny_cfg

from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
from boxinstseg_tpu_torch.engine.schedules import build_lr_schedule
from boxinstseg_tpu_torch.engine.train_state import make_train_step
from boxinstseg_tpu_torch.registry import LOSSES, build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax

ATOL, RTOL = 1e-5, 1e-4
KERNEL_SCALE = 1000.0
MIN_DETS = 10
SHIPPED = 'configs/boxlevelset/box_levelset_coco_r50_fpn_3x.py'
TEST_CFG = dict(nms_pre=50, score_thr=0.005, mask_thr=0.5,
                filter_thr=0.002, kernel='gaussian', sigma=2.0,
                max_per_img=20)


def cfg_with(tf_max_depth):
    cfg = tiny_cfg()
    cfg['bbox_head'] = dict(cfg['bbox_head'], tf_max_depth=tf_max_depth)
    cfg['test_cfg'] = dict(TEST_CFG)
    return cfg


def make_batch(seed):
    return {k: np.asarray(v) for k, v in synth_batch(
        np.random.RandomState(seed)).items()}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out['image'] = out['image'].permute(0, 3, 1, 2).contiguous()
    return out


@pytest.fixture(scope='module')
def variables():
    """The JAX init of the tiny BoxLevelSet, the kernel branch's last conv
    scaled, as numpy trees."""
    jm = j_build(cfg_with(64))
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)},
                       jax_batch(make_batch(0)), jnp.zeros((), jnp.int32),
                       method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    head = v['params']['bbox_head_m']
    head['solo_kernel'] = dict(head['solo_kernel'],
                               kernel=head['solo_kernel']['kernel']
                               * KERNEL_SCALE)
    return v


@pytest.fixture(scope='module')
def jax_loss_and_grads(variables):
    """The JAX loss dict and parameter gradients at tf_max_depth 64 on
    batch 1, jitted once for the module."""
    jm = j_build(cfg_with(64))
    rest = {k: x for k, x in variables.items() if k != 'params'}

    def total(params, b):
        losses = jm.apply({'params': params, **rest}, b,
                          jnp.zeros((), jnp.int32), method=jm.loss)
        return sum(losses.values()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        variables['params'], jax_batch(make_batch(1)))
    return (jax.tree_util.tree_map(np.asarray, losses),
            jax.tree_util.tree_map(np.asarray, grads))


def port_model(v, tf_max_depth=64):
    tm = build_detector(cfg_with(tf_max_depth))
    tm.load_state_dict(params_from_jax(v['params'], v.get('batch_stats')),
                       strict=True)
    return tm.train()


def test_shipped_config_builds_at_full_width():
    cfg = Config.fromfile(SHIPPED)
    with torch.device('meta'):
        tm = build_detector(cfg.model.copy())
    head = tm.bbox_head
    assert type(tm).__name__ == 'BoxLevelSet'
    assert head.num_grids == (40, 36, 24, 16, 12)
    assert (head.max_pos, head.tf_size, head.tf_max_depth) == (196, (96, 96),
                                                              0)
    assert len(head.kernel_convs) == 4
    assert head.solo_mask.weight.shape == (256, 256, 1, 1)
    assert head.levelset_bottom.weight.shape == (5, 256, 3, 3)
    assert [len(list(level.children())) for level in head.feature_convs] \
        == [1, 1, 2, 3]


@pytest.mark.parametrize('key', ['loss_boxpro', 'loss_levelset'])
def test_registered_losses_match_jax(key):
    spec = dict(Config.fromfile(SHIPPED).model.bbox_head[key])
    rng = np.random.RandomState(0)
    if key == 'loss_boxpro':
        scores = rng.rand(5, 12, 16).astype(np.float32)
        boxes = (rng.rand(5, 12, 16) > 0.5).astype(np.float32)
        valid = np.array([1, 1, 0, 1, 0], bool)
        args = (scores, boxes, valid)
    else:
        phi = rng.rand(5, 12, 16).astype(np.float32)
        args = (np.stack([phi, 1 - phi], 1),
                rng.rand(5, 3, 12, 16).astype(np.float32),
                rng.rand(5).astype(np.float32) * 100 + 1)
    want = np.asarray(J_LOSSES.build(dict(spec))(*map(jnp.asarray, args)))
    got = LOSSES.build(dict(spec))(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape == (5,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    assert (want != 0).sum() >= 3


def test_head_forward_matches_jax(variables):
    jm = j_build(cfg_with(64))
    image = make_batch(1)['image']
    want = jax.jit(lambda v, x: jm.apply(v, x, True))(variables, image)
    tm = port_model(variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(image).permute(0, 3, 1, 2))
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        if g.ndim == 4:
            g = g.transpose(0, 2, 3, 1)
        if k == 'kernels':      # the scaled conv's output, at its own scale
            g, w = g / KERNEL_SCALE, w / KERNEL_SCALE
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize('tf_max_depth', [0, 64])
def test_loss_dict_matches_jax(variables, jax_loss_and_grads, tf_max_depth):
    batch = make_batch(1)
    if tf_max_depth == 64:
        want = jax_loss_and_grads[0]
    else:
        jm = j_build(cfg_with(tf_max_depth))
        want = jax.jit(lambda v, b: jm.apply(
            v, b, jnp.zeros((), jnp.int32), method=jm.loss))(
            variables, jax_batch(batch))
    tm = port_model(variables, tf_max_depth)
    with torch.no_grad():
        got = tm.loss(torch_batch(batch), 0)
    assert set(got) == {'loss_cate', 'loss_boxpro', 'loss_levelset'}
    assert set(got) == set(want)
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), rel=RTOL), k
        assert float(want[k]) > 0, k


def test_gradients_match_jax(variables, jax_loss_and_grads):
    tm = port_model(variables)
    losses = tm.loss(torch_batch(make_batch(1)), 0)
    sum(losses.values()).backward()
    jg = params_from_jax(jax_loss_and_grads[1], variables.get('batch_stats'))
    tg = {k: p.grad for k, p in tm.named_parameters()}
    assert set(tg) <= set(jg)
    nonzero = 0
    for k, got in tg.items():
        want = jg[k].numpy()
        if got is None:                      # a frozen stage
            assert not want.any(), k
            continue
        nonzero += bool(want.any())
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6,
                                   err_msg=k)
    assert tg['bbox_head.levelset_bottom.weight'].abs().max() > 0
    assert nonzero > len(tg) // 2


def test_one_adamw_step_matches_jax_train_step(variables):
    cfg = Config.fromfile(SHIPPED)
    opt, opt_cfg = dict(cfg.optimizer), dict(cfg.optimizer_config)
    assert opt['type'] == 'AdamW' and opt['paramwise_cfg'] \
        and opt_cfg['grad_clip']['max_norm'] == 1
    # the recipe's optimizer at its full LR (its warmup starts at 1e-6)
    lr_cfg = dict(policy='fixed')
    jm = j_build(cfg_with(64))
    tx = j_optimizer(opt, j_schedule(lr_cfg, opt['lr'], 100),
                     optimizer_config=opt_cfg,
                     params_example=variables['params'])
    state, jl = j_train_step(jm, tx, donate=False)(
        create_train_state(jm, variables, tx), jax_batch(make_batch(2)))
    tm = port_model(variables)
    optimizer = build_optimizer(opt, tm.named_parameters())
    tl = make_train_step(tm, optimizer, build_lr_schedule(
        lr_cfg, opt['lr'], 100), opt_cfg['grad_clip'])(
        torch_batch(make_batch(2)), 0)
    for k in jl:
        assert tl[k].item() == pytest.approx(float(jl[k]), rel=RTOL,
                                             abs=1e-6), k
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                           variables.get('batch_stats'))
    init = params_from_jax(variables['params'], variables.get('batch_stats'))
    sd = tm.state_dict()
    # Adam moves an entry by lr * m / (sqrt(v) + eps): where the gradient
    # sits at float-noise level its sign, and so the whole step, is noise;
    # a few such entries may differ, by at most two steps
    moved = off = total = 0
    for k, w in want.items():
        got, w = sd[k].numpy(), w.numpy()
        off += int((~np.isclose(got, w, rtol=RTOL, atol=1e-6)).sum())
        total += w.size
        np.testing.assert_allclose(got, w, rtol=0, atol=2 * opt['lr'],
                                   err_msg=k)
        moved += not np.array_equal(w, init[k].numpy())
    assert off <= 1e-4 * total, (off, total)
    assert moved > len(want) // 2


def test_get_seg_matches_jax(variables):
    jm = j_build(cfg_with(64))
    image = make_batch(3)['image']
    want = jax.device_get(jax.jit(lambda v, x: jm.apply(
        v, {'image': x}, method=jm.predict))(variables, image))
    tm = port_model(variables).eval()
    got = {k: x.numpy() for k, x in tm.predict(
        {'image': torch.from_numpy(image).permute(0, 3, 1, 2)}).items()}
    d = TEST_CFG['max_per_img']
    assert got['masks'].shape == want['masks'].shape == (2, d, H // 4,
                                                         W // 4)
    np.testing.assert_array_equal(got['valid'], want['valid'])
    m = want['valid']
    assert (m.sum(1) >= MIN_DETS).all(), m.sum(1)
    # no near-tie decides the order
    err = np.abs(got['scores'][m] - want['scores'][m]).max()
    for s, v in zip(want['scores'], m):
        assert np.diff(np.sort(s[v])).min() > 2 * err
    np.testing.assert_array_equal(got['labels'][m], want['labels'][m])
    np.testing.assert_allclose(got['scores'][m], want['scores'][m],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got['masks'][m], want['masks'][m], atol=ATOL,
                               rtol=0)
    assert not got['scores'][~m].any()


def test_params_from_jax_round_trips_through_converter(variables):
    p, s = convert_reference_checkpoint(
        params_from_jax(variables['params'], variables.get('batch_stats')))
    for want, got in ((variables['params'], p),
                      (variables.get('batch_stats', {}), s)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]),
                                          np.asarray(leaf))
