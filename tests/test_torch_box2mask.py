"""The port's Box2Mask training slice against the JAX package, on the CPU.

A tiny Box2Mask (ResNet-18, 32 channels, 2 encoder and 3 decoder layers,
10 queries; the config of ``tests/test_box2mask_model.py``) with the same
weights (JAX init converted by ``params_from_jax``) and the same seeded
batch:

- the Hungarian costs and assignment, with padded GT slots;
- the whole loss dict, every ``d{i}.*`` key, with the tree depth cap
  uncapped (``tf_max_depth=0``) and binding (64), rtol 1e-4;
- two AdamW steps of the shipped recipe's optimizer (paramwise
  multipliers, grad clip 0.01) against ``make_train_step``: logs and every
  parameter (rtol 1e-4, atol 1e-6);
- the per-parameter (lr_mult, decay_mult) table against the JAX
  ``paramwise_fns`` for every leaf, with the shipped R-50 config and the
  shipped Swin-L config (the Swin recipe's ``custom_keys``) too;
- ``params_from_jax`` round-trips through ``convert_reference_checkpoint``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.config import Config as JConfig
from boxinstseg_tpu.core.targets.hungarian import (
    box_matching_cost as j_box_cost, classification_cost as j_cls_cost,
    hungarian_match as j_match)
from boxinstseg_tpu.engine import (build_lr_schedule as j_schedule,
                                   build_optimizer as j_optimizer,
                                   create_train_state, init_variables,
                                   make_train_step as j_train_step)
from boxinstseg_tpu.engine.optimizers import _path_str, paramwise_fns
from boxinstseg_tpu.registry import build_detector as j_build
from boxinstseg_tpu.utils.checkpoint_convert import \
    convert_reference_checkpoint
from test_box2mask_model import synth_batch, tiny_cfg

from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.core.targets.hungarian import (
    box_matching_cost, classification_cost, hungarian_match)
from boxinstseg_tpu_torch.engine.optimizers import (build_optimizer,
                                                    paramwise_multipliers)
from boxinstseg_tpu_torch.engine.schedules import build_lr_schedule
from boxinstseg_tpu_torch.engine.train_state import make_train_step
from boxinstseg_tpu_torch.registry import build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax

SHIPPED = 'configs/box2mask/box2mask_r50_lsj_8x2_50e_coco.py'
SWIN_L = 'configs/box2mask/box2mask_swin-l-p4-w12-384-lsj_8x1_50e_coco.py'


def cfg_with(tf_max_depth):
    cfg = tiny_cfg()
    cfg['panoptic_head'] = dict(cfg['panoptic_head'],
                                tf_max_depth=tf_max_depth)
    return cfg


def make_batch(seed):
    return {k: np.asarray(v) for k, v in synth_batch(
        np.random.RandomState(seed)).items()}


def torch_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out['image'] = out['image'].permute(0, 3, 1, 2).contiguous()
    return out


@pytest.fixture(scope='module')
def variables():
    jm = j_build(cfg_with(64))
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)},
                       {k: jnp.asarray(x) for k, x in make_batch(0).items()},
                       jnp.zeros((), jnp.int32), method=jm.loss)
    return jax.tree_util.tree_map(np.asarray, dict(v))


def port_model(v, tf_max_depth=64):
    tm = build_detector(cfg_with(tf_max_depth))
    tm.load_state_dict(params_from_jax(v['params'], v.get('batch_stats')),
                       strict=True)
    return tm.train()


def test_hungarian_costs_and_assignment_match_jax():
    rng = np.random.RandomState(0)
    b, q, g, c = 3, 12, 6, 5
    cls = rng.randn(b, q, c + 1).astype(np.float32)
    masks = rng.randn(b, q, 9, 11).astype(np.float32)
    boxes = (rng.rand(b, g, 9, 11) > 0.6).astype(np.float32)
    labels = rng.randint(0, c, (b, g))
    valid = np.zeros((b, g), bool)
    valid[0, :4] = True
    valid[1, [0, 2, 5]] = True          # padded slots between valid ones
    cost_j = 2 * j_cls_cost(jnp.asarray(cls), jnp.asarray(labels)) \
        + 5 * j_box_cost(jnp.asarray(masks), jnp.asarray(boxes))
    cost_t = 2 * classification_cost(torch.from_numpy(cls),
                                     torch.from_numpy(labels)) \
        + 5 * box_matching_cost(torch.from_numpy(masks),
                                torch.from_numpy(boxes))
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_j),
                               atol=1e-5, rtol=1e-4)
    want, want_v = j_match(cost_j, jnp.asarray(valid))
    got, got_v = hungarian_match(cost_t, torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize('tf_max_depth', [0, 64])
def test_loss_dict_matches_jax(variables, tf_max_depth):
    jm = j_build(cfg_with(tf_max_depth))
    batch = make_batch(1)
    want = jax.jit(lambda v, b: jm.apply(v, b, jnp.zeros((), jnp.int32),
                                         method=jm.loss))(
        variables, {k: jnp.asarray(x) for k, x in batch.items()})
    tm = port_model(variables, tf_max_depth)
    with torch.no_grad():
        got = tm.loss(torch_batch(batch))
    assert set(got) == set(want)
    assert 'd0.loss_levelset' in got and 'd2.loss_cls' in got
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), rel=1e-4), k
    assert all(float(want[k]) > 0 for k in want)


def _shipped_optimizer():
    cfg = Config.fromfile(SHIPPED)
    return dict(cfg.optimizer), dict(cfg.optimizer_config), dict(
        cfg.lr_config)


def test_two_adamw_steps_match_jax_train_step(variables):
    opt, opt_cfg, lr_cfg = _shipped_optimizer()
    assert opt['type'] == 'AdamW' and opt['paramwise_cfg']
    jm = j_build(cfg_with(64))
    j_lr = j_schedule(lr_cfg, opt['lr'], 100, by_epoch=False)
    tx = j_optimizer(opt, j_lr, optimizer_config=opt_cfg,
                     params_example=variables['params'])
    state = create_train_state(jm, variables, tx)
    j_step = j_train_step(jm, tx, donate=False)
    tm = port_model(variables)
    optimizer = build_optimizer(opt, tm.named_parameters())
    t_step = make_train_step(tm, optimizer, build_lr_schedule(
        lr_cfg, opt['lr'], 100, by_epoch=False), opt_cfg['grad_clip'])
    for i in range(2):
        batch = make_batch(10 + i)
        state, jl = j_step(state, {k: jnp.asarray(x)
                                   for k, x in batch.items()})
        tl = t_step(torch_batch(batch), i)
        for k in jl:
            assert tl[k].item() == pytest.approx(float(jl[k]), rel=1e-4,
                                                 abs=1e-6), (i, k)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                           variables.get('batch_stats'))
    sd = tm.state_dict()
    init = params_from_jax(variables['params'], variables.get('batch_stats'))
    # Adam moves an entry by lr * m / (sqrt(v) + eps): where the gradient
    # sits at float-noise level its sign, and so a whole step, is noise. A
    # few such entries may differ, each by at most the two steps' largest
    # move; all the others match tightly.
    moved = off = total = 0
    for k, w in want.items():
        got, w = sd[k].numpy(), w.numpy()
        off += int((~np.isclose(got, w, rtol=1e-4, atol=1e-6)).sum())
        total += w.size
        np.testing.assert_allclose(got, w, rtol=0, atol=4 * opt['lr'],
                                   err_msg=k)
        moved += not np.array_equal(w, init[k].numpy())
    assert off <= 1e-4 * total, (off, total)
    assert moved > len(want) // 2


def _jax_leaf_multipliers(opt, params):
    lr_mult, wd_mult = paramwise_fns(opt)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {_path_str(p): (lr_mult(_path_str(p)),
                           wd_mult(_path_str(p), leaf)) for p, leaf in flat}


def _port_leaf_multipliers(opt, model):
    """Port name -> multipliers, and JAX leaf path -> port name (every
    tensor filled with its index goes through the converter)."""
    lr_mult, decay_mult = paramwise_multipliers(opt)
    names = [n for n, _ in model.named_parameters()]
    table = {n: (lr_mult(n), decay_mult(n, p))
             for n, p in model.named_parameters()}
    # zero-stride CPU tensors, so that a model built on the meta device
    # converts too
    sd = {k: torch.tensor(float(names.index(k)) if k in names
                          else -1.0).expand(v.shape)
          for k, v in model.state_dict().items()}
    params, _ = convert_reference_checkpoint(sd)
    owner = {}
    for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        ids = np.unique(np.asarray(leaf))
        assert len(ids) == 1 and ids[0] >= 0, _path_str(p)
        owner[_path_str(p)] = names[int(ids[0])]
    return table, owner


@pytest.mark.parametrize('config', ['tiny', 'shipped', 'swin-l'])
def test_paramwise_multipliers_match_jax_for_every_leaf(variables, config):
    opt, _, _ = _shipped_optimizer()
    if config == 'tiny':
        model, params = port_model(variables), variables['params']
    else:
        # Swin-L at 384x384, where no stage's map is smaller than the
        # window of 12; the JAX tree is abstract and the port's on the meta
        # device, so neither allocates Swin-L's weights
        path, side = (SWIN_L, 384) if config == 'swin-l' else (SHIPPED, 64)
        if config == 'swin-l':
            opt = dict(Config.fromfile(SWIN_L).optimizer)
        cfg = JConfig.fromfile(path).model
        cfg.backbone.pop('init_cfg', None)
        jm = j_build(cfg)
        x = jnp.zeros((1, side, side, 3), jnp.float32)
        params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))[
            'params']
        with torch.device('meta'):
            model = build_detector(Config.fromfile(path).model)
    want = _jax_leaf_multipliers(opt, params)
    table, owner = _port_leaf_multipliers(opt, model)
    assert set(owner) == set(want)
    assert set(owner.values()) == set(table)
    for path, mults in want.items():
        assert table[owner[path]] == mults, (path, owner[path])
    kinds = set(want.values())
    assert {(0.1, 1.0), (1.0, 0.0), (1.0, 1.0)} <= kinds
    if config == 'swin-l':
        # backbone norms and the relative-position tables: 0.1x lr, no decay
        assert (0.1, 0.0) in kinds
        assert table['backbone.stages.2.blocks.1.norm1.weight'] == (0.1, 0.0)
        assert table['backbone.stages.2.blocks.10.norm1.weight'] == (0.1,
                                                                     1.0)
        assert table['backbone.norm3.bias'] == (0.1, 0.0)
        assert table['backbone.stages.3.blocks.1.attn.w_msa.'
                     'relative_position_bias_table'] == (0.1, 0.0)


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
