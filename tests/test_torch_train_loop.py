"""The rest of the port's train loop against the JAX package on the CPU.

- the ``poly``, ``CosineAnnealing`` and ``YOLOX`` LR policies equal JAX
  ``build_lr_schedule`` at every step of a run (rtol 1e-6), with and
  without warmup, ``min_lr`` / ``min_lr_ratio``, ``by_epoch`` True and
  False, YOLOX's ``num_last_epochs``; an unknown policy raises in both;
- ``LayerDecayOptimizerConstructor``: every parameter's ``(lr_mult,
  decay_mult)`` of a small Swin Box2Mask and a small ResNet BoxInst equals
  JAX ``paramwise_fns`` on the JAX path of the same tensor (each JAX leaf
  filled with its own index and passed through ``params_from_jax``);
- ``EMAHook`` and its two momentum-scheduled subclasses over 5 updates of
  converted parameters against the JAX hooks (atol 1e-6);
- ``SetEpochInfoHook`` and ``YOLOXModeSwitchHook`` on the fakes of
  tests/test_hooks_zoo.py, beside the JAX hooks;
- ``ProfilerHook`` writes a trace on the CPU; ``profile_time`` times a
  block; ``WandbLoggerHook`` no-ops, with one warning, without ``wandb``;
- ``build_hooks`` of a config naming every hook gives the JAX types in the
  JAX order with the JAX arguments; an unknown type still raises;
- ``train_detector`` runs a YOLOX schedule (the first step's LR 0) with the
  EMA, profiler, memory, epoch-info and sync hooks.

The JAX schedules run in float32, where ``1 + cos`` cancels near the end of
a cosine (5.5e-5 relative at step 99 of 100 with ``min_lr`` 0); they are
evaluated here with ``jax.enable_x64``, in float64 like the port's.
"""
import logging
import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.apis.train import (build_hooks as j_build_hooks,
                                       resolve_intervals as j_intervals)
from boxinstseg_tpu.config import Config as JConfig
from boxinstseg_tpu.data.coco import MultiImageMixDataset as JMixDataset
from boxinstseg_tpu.engine import hooks as JH
from boxinstseg_tpu.engine.optimizers import _path_str, paramwise_fns
from boxinstseg_tpu.engine.schedules import \
    build_lr_schedule as j_schedule
from boxinstseg_tpu.registry import build_detector as j_build
from test_torch_slice import (_TinyBoxDataset, make_batch as boxinst_batch,
                              tiny_cfg as boxinst_cfg)
from test_torch_swin import make_batch as swin_batch, swin_box2mask_cfg

from boxinstseg_tpu_torch.apis.train import (TrainResult, build_hooks,
                                             resolve_intervals,
                                             train_detector)
from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.data.coco import MultiImageMixDataset
from boxinstseg_tpu_torch.engine import hooks as H
from boxinstseg_tpu_torch.engine.optimizers import paramwise_multipliers
from boxinstseg_tpu_torch.engine.schedules import build_lr_schedule
from boxinstseg_tpu_torch.registry import build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN_L = os.path.join(
    ROOT, 'configs/box2mask/box2mask_swin-l-p4-w12-384-lsj_8x1_50e_coco.py')

# ------------------------------------------------------------ LR policies

POLICIES = {
    'poly': dict(policy='poly', power=0.9),
    'poly, min_lr, linear warmup': dict(policy='poly', power=2.0,
                                        min_lr=1e-4, warmup='linear',
                                        warmup_iters=7, warmup_ratio=0.01),
    'cosine, min_lr': dict(policy='CosineAnnealing', min_lr=0.0),
    'cosine, min_lr_ratio, linear warmup': dict(
        policy='CosineAnnealing', min_lr_ratio=0.01, warmup='linear',
        warmup_iters=9, warmup_ratio=0.1),
    'cosine by epoch': dict(policy='cosine', min_lr=2e-3, by_epoch=True,
                            warmup='linear', warmup_iters=3),
    'yolox': dict(policy='YOLOX', warmup_iters=6, num_last_epochs=2,
                  min_lr_ratio=0.05),
    'yolox_cosine, no warmup': dict(policy='yolox_cosine',
                                    num_last_epochs=1),
}


@pytest.mark.parametrize('name', list(POLICIES))
@pytest.mark.parametrize('by_epoch', [True, False])
def test_lr_policies_match_jax_at_every_step(name, by_epoch):
    lr_cfg, base, ipe, max_iters = POLICIES[name], 0.02, 10, 100
    port = build_lr_schedule(lr_cfg, base, ipe, by_epoch=by_epoch,
                             max_iters=max_iters)
    with jax.enable_x64(True):
        want = j_schedule(lr_cfg, base, ipe, by_epoch=by_epoch,
                          max_iters=max_iters)
        want = [float(want(i)) for i in range(max_iters + 1)]
    got = [port(i) for i in range(max_iters + 1)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert all(isinstance(v, float) for v in got)
    if lr_cfg['policy'] in ('YOLOX', 'yolox_cosine'):
        # held at min_lr over the last epochs; the warmup starts at 0
        assert got[-1] == base * lr_cfg.get('min_lr_ratio', 0.05)
        assert got[0] == (0.0 if lr_cfg.get('warmup_iters') else base)


def test_an_unknown_policy_raises_in_both():
    with pytest.raises(ValueError, match='OneCycle'):
        build_lr_schedule(dict(policy='OneCycle'), 0.01, 10)
    with pytest.raises(ValueError, match='OneCycle'):
        j_schedule(dict(policy='OneCycle'), 0.01, 10)


# ------------------------------------------------------------ layer decay

def _jax_variable_shapes(cfg, batch):
    """The JAX model's variables as shapes (traced, not compiled)."""
    jm = j_build(cfg)
    b = {k: jnp.asarray(x) for k, x in batch.items()}
    return jax.eval_shape(lambda: jm.init(
        {'params': jax.random.PRNGKey(0)}, b, jnp.zeros((), jnp.int32),
        method=jm.loss))


@pytest.fixture(scope='module')
def indexed_models():
    """For a small Swin Box2Mask and a small ResNet BoxInst: the port's
    named parameters, each paired with the JAX (path, leaf) pairs whose
    values it holds. Every JAX leaf is filled with its index + 1 and
    converted by ``params_from_jax``, so a port tensor's distinct nonzero
    values name its JAX leaves."""
    out = {}
    for name, cfg, batch in (
            ('swin box2mask', swin_box2mask_cfg(), swin_batch(0)),
            ('resnet boxinst', boxinst_cfg(), boxinst_batch(0))):
        shapes = _jax_variable_shapes(cfg, batch)
        leaves, treedef = jax.tree_util.tree_flatten_with_path(
            shapes['params'])
        paths = [_path_str(p) for p, _ in leaves]
        params = jax.tree_util.tree_unflatten(treedef, [
            np.full(s.shape, i + 1, np.float32)
            for i, (_, s) in enumerate(leaves)])
        stats = jax.tree_util.tree_map(
            lambda s: np.ones(s.shape, np.float32),
            shapes.get('batch_stats', {}))
        sd = params_from_jax(params, stats)
        model = build_detector(cfg)
        model.load_state_dict(sd, strict=True)
        pairs = []
        for pname, p in model.named_parameters():
            ids = sorted({int(v) for v in np.unique(sd[pname].numpy())
                          if v > 0})
            assert ids, pname
            pairs.append((pname, p, [(paths[i - 1], leaves[i - 1][1])
                                     for i in ids]))
        assert {i for _, _, js in pairs for i, _ in js} == set(paths)
        out[name] = pairs
    return out


def layer_decay_cfgs():
    """The Swin-L recipe's optimizer with the LayerDecay constructor, at
    the mmdet defaults and at a cap that binds; SGD on a ResNet."""
    swin = dict(JConfig.fromfile(SWIN_L).optimizer)
    pw = dict(swin['paramwise_cfg'])
    return {
        'adamw, 12 layers': dict(
            swin, constructor='LayerDecayOptimizerConstructor',
            paramwise_cfg=dict(pw, num_layers=12, layer_decay_rate=0.9)),
        'adamw, 3 layers, decay_rate': dict(
            swin, constructor='LayerDecayOptimizerConstructor',
            paramwise_cfg=dict(pw, num_layers=3, decay_rate=0.8)),
        'sgd, defaults': dict(
            type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4,
            constructor='LayerDecayOptimizerConstructor',
            paramwise_cfg=dict(custom_keys={'backbone': dict(lr_mult=0.5)},
                               norm_decay_mult=0.0)),
    }


@pytest.mark.parametrize('model', ['swin box2mask', 'resnet boxinst'])
@pytest.mark.parametrize('opt', list(layer_decay_cfgs()))
def test_layer_decay_multipliers_match_jax_for_every_parameter(
        indexed_models, model, opt):
    cfg = layer_decay_cfgs()[opt]
    lr_mult, decay_mult = paramwise_multipliers(cfg)
    j_lr, j_wd = paramwise_fns(cfg)
    decayed = set()
    for name, p, jax_leaves in indexed_models[model]:
        got = (lr_mult(name), decay_mult(name, p))
        for path, leaf in jax_leaves:
            want = (j_lr(path), j_wd(path, leaf))
            assert got == pytest.approx(want, rel=1e-12), (name, path)
        if name.startswith('backbone.'):
            decayed.add(got[0])
    # the rule is not vacuous: the backbone spans several layer ids
    assert len(decayed) >= 3, decayed


def test_a_resnet_block_conv1_takes_layer_0_as_in_jax():
    """Kept divergence from mmdet: the JAX rule tries ``conv1|bn1``
    first, anywhere in the path, so a ResNet block's own conv1 / bn1 get
    layer 0 while its conv2 gets the block's id."""
    cfg = layer_decay_cfgs()['sgd, defaults']
    lr_mult, _ = paramwise_multipliers(cfg)
    assert lr_mult('backbone.layer3.1.conv1.weight') == \
        pytest.approx(0.5 * 0.9 ** 13)
    assert lr_mult('backbone.layer3.1.conv2.weight') == \
        pytest.approx(0.5 * 0.9 ** (13 - 6))
    with pytest.raises(NotImplementedError, match='Foo'):
        paramwise_multipliers(dict(cfg, constructor='Foo'))


# ------------------------------------------------------------------- EMA

class _State:
    """The port hooks' ``state``: only ``model`` is read."""

    def __init__(self, model):
        self.model = model


class _JState:
    params = None


EMA_HOOKS = {
    'EMAHook': lambda m: m.EMAHook(momentum=0.7, interval=1),
    'ExpMomentumEMAHook': lambda m: m.ExpMomentumEMAHook(
        momentum=0.05, total_iter=4, interval=2),
    'LinearMomentumEMAHook': lambda m: m.LinearMomentumEMAHook(
        momentum=0.3, warm_up=3, interval=1),
}


@pytest.fixture(scope='module')
def boxinst_shapes():
    return _jax_variable_shapes(boxinst_cfg(), boxinst_batch(0))


@pytest.mark.parametrize('kind', list(EMA_HOOKS))
def test_ema_hooks_match_jax_over_five_updates(boxinst_shapes, kind):
    rng = np.random.RandomState(3)
    stats = jax.tree_util.tree_map(
        lambda s: np.ones(s.shape, np.float32),
        boxinst_shapes['batch_stats'])
    model = build_detector(boxinst_cfg())
    port, ref = EMA_HOOKS[kind](H), EMA_HOOKS[kind](JH)
    jstate = _JState()
    steps = 5 * port.interval
    for i in range(steps):
        params = jax.tree_util.tree_map(
            lambda s: np.asarray(rng.standard_normal(s.shape), np.float32),
            boxinst_shapes['params'])
        model.load_state_dict(params_from_jax(params, stats))
        jstate.params = jax.tree_util.tree_map(jnp.asarray, params)
        port.after_step(i, _State(model), {})
        ref.after_step(i, jstate, {})
    want = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                  ref.ema_params), stats)
    assert set(port.ema_params) == {k for k, _ in model.named_parameters()}
    for k, got in port.ema_params.items():
        np.testing.assert_allclose(got.numpy(), want[k].numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)
    # after 5 updates the average is far from the last parameters
    last = dict(model.named_parameters())
    assert not torch.allclose(port.ema_params['backbone.conv1.weight'],
                              last['backbone.conv1.weight'])


# ------------------------------------------------- epoch info, YOLOX switch

class _FakeDS:
    CLASSES = ('a',)
    flag = np.zeros(4, np.uint8)

    def __len__(self):
        return 4

    def prepare(self, idx, rng=None, scale=None):
        return {'x': idx}


class _Head:
    use_l1 = False


class _Model:
    def __init__(self):
        self.bbox_head = _Head()
        self.epoch = None

    def set_epoch(self, e):
        self.epoch = e


@pytest.mark.parametrize('pkg', ['port', 'jax'])
def test_set_epoch_info_and_yolox_mode_switch(pkg):
    hooks, mix = (H, MultiImageMixDataset) if pkg == 'port' \
        else (JH, JMixDataset)
    m = _Model()
    ds = mix(_FakeDS(), [dict(type='RandomFlip', flip_ratio=0.0)])
    hook = hooks.YOLOXModeSwitchHook(num_last_epochs=2, model=m, dataset=ds,
                                     max_epochs=10,
                                     skip_type_keys=('RandomFlip',))
    hook.after_epoch(5, None)          # not the trigger epoch
    assert not m.bbox_head.use_l1 and len(ds.pipeline.transforms) == 1
    hook.after_epoch(7, None)          # (7 + 2) == 10 - 2 + 1
    assert m.bbox_head.use_l1 and len(ds.pipeline.transforms) == 0
    se = hooks.SetEpochInfoHook(m)
    se.after_epoch(3, None)
    assert m.epoch == 4
    hooks.SetEpochInfoHook(object()).after_epoch(3, None)   # no set_epoch


# ------------------------------------------------------ profiler, wandb

def test_profiler_hook_writes_a_trace_on_the_cpu(tmp_path, caplog):
    from boxinstseg_tpu_torch.utils.profiling import span
    hook = H.ProfilerHook(start=2, stop=3, log_dir=str(tmp_path / 'prof'))
    x = torch.randn(64, 64)
    with caplog.at_level(logging.INFO, logger='boxinstseg_tpu_torch'):
        for i in range(4):
            hook.after_step(i, None, {})
            with span('step'), span('step.mm'):
                x = torch.mm(x, x).tanh()
    assert hook.path == str(tmp_path / 'prof' / 'trace.json')
    text = open(hook.path).read()
    # the window holds the ops run after step 2 and before step 3 ends,
    # and the port's spans around them
    assert text.count('"aten::mm"') == 1 and '"aten::tanh"' in text
    assert text.count('"bis:step"') == 1 and '"bis:step.mm"' in text
    # the window's recording: each span's self host ms a step, the syncs
    spans = next(r.getMessage() for r in caplog.records
                 if r.getMessage().startswith('host ms a step by span'))
    assert 'step.mm ' in spans and 'step ' in spans
    assert any(r.getMessage().startswith('host syncs')
               for r in caplog.records)


def test_profile_time_and_memory_stats_on_the_cpu(capsys):
    from boxinstseg_tpu_torch.utils.profiling import (device_memory_stats,
                                                      profile_time)
    with profile_time('mm', device='cpu'):
        torch.mm(torch.randn(32, 32), torch.randn(32, 32))
    out = capsys.readouterr().out
    assert out.startswith('mm: ') and out.rstrip().endswith(' ms')
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}


def test_wandb_hook_noops_without_wandb(monkeypatch, caplog):
    monkeypatch.setitem(__import__('sys').modules, 'wandb', None)
    with caplog.at_level(logging.WARNING, logger='boxinstseg_tpu_torch'):
        hook = H.WandbLoggerHook(interval=1)
        for i in range(3):
            hook.after_step(i, None, {'loss': torch.tensor(1.0)})
    assert hook.wandb is None
    warned = [r for r in caplog.records if 'wandb' in r.getMessage()]
    assert len(warned) == 1 and warned[0].levelno == logging.WARNING
    assert JH.WandbLoggerHook(1).wandb is None


# ------------------------------------------------------------ build_hooks

EVERY_HOOK = dict(
    log_config=dict(interval=2, hooks=[dict(type='TextLoggerHook'),
                                       dict(type='MMDetWandbHook',
                                            interval=3)]),
    custom_hooks=[
        dict(type='NumClassCheckHook'),
        dict(type='EMAHook', momentum=0.99, interval=2),
        dict(type='ExpMomentumEMAHook', total_iter=50),
        dict(type='LinearMomentumEMAHook', momentum=0.001, warm_up=7),
        dict(type='SetEpochInfoHook'),
        dict(type='YOLOXModeSwitchHook', num_last_epochs=3),
        dict(type='SyncNormHook', num_last_epochs=15, interval=1),
        dict(type='SyncRandomSizeHook', ratio_range=(14, 26)),
        dict(type='MemoryProfilerHook', interval=4),
        dict(type='ProfilerHook', start=3, stop=5, log_dir='prof'),
    ],
    runner=dict(type='IterBasedRunner', max_iters=20))

ARGS = ('interval', 'momentum', 'start', 'stop', 'log_dir',
        'num_last_epochs', 'skip_type_keys', 'max_epochs')


def test_build_hooks_gives_the_jax_types_in_the_jax_order(tmp_path, caplog):
    cfg = Config.fromdict(dict(model=boxinst_cfg(), **EVERY_HOOK))
    iv = resolve_intervals(cfg, 5)
    iv.update(max_epochs=4, train_dataset=None)
    model = _Model()
    with caplog.at_level(logging.WARNING, logger='boxinstseg_tpu_torch'):
        got = build_hooks(cfg, iv, str(tmp_path), None, TrainResult(step=0),
                          model=model)
    jcfg = JConfig.fromdict(dict(model=boxinst_cfg(), **EVERY_HOOK))
    jiv = j_intervals(jcfg, 5)
    jiv.update(max_epochs=4, train_dataset=None)
    want = j_build_hooks(model, jcfg, jiv, str(tmp_path / 'ckpt'),
                         logger=logging.getLogger('jax_hooks'))
    assert [type(h).__name__ for h in got] == \
        [type(h).__name__ for h in want]
    assert len(got) == 13
    for g, w in zip(got, want):
        for a in ARGS:
            if hasattr(w, a):
                assert getattr(g, a) == getattr(w, a), (type(g), a)
        if isinstance(w, JH.EMAHook):
            for t in (0, 3, 40):
                assert g.keep_rate(t) == w._keep_rate(t)
        if isinstance(w, JH.YOLOXModeSwitchHook):
            assert g.model is model
    assert [r for r in caplog.records if 'wandb' in r.getMessage()]


@pytest.mark.parametrize('where', ['custom_hooks', 'log_config'])
def test_a_hook_type_the_jax_package_lacks_raises(tmp_path, where):
    extra = dict(custom_hooks=[dict(type='FooHook')]) \
        if where == 'custom_hooks' else \
        dict(log_config=dict(hooks=[dict(type='PaviLoggerHook')]))
    cfg = Config.fromdict(dict(model=boxinst_cfg(), **extra,
                               runner=dict(type='IterBasedRunner',
                                           max_iters=2)))
    with pytest.raises(NotImplementedError,
                       match='FooHook' if where == 'custom_hooks'
                       else 'PaviLoggerHook'):
        build_hooks(cfg, resolve_intervals(cfg, 1), str(tmp_path), None,
                    TrainResult(step=0))


def test_train_detector_runs_every_hook(tmp_path, caplog):
    """A YOLOX schedule's first step logs LR 0; the EMA is the parameters'
    copy after the first update and moves after; the trace of step 2
    exists; on the CPU the memory hook logs no card."""
    prof = tmp_path / 'prof'
    cfg = Config.fromdict(dict(
        model=boxinst_cfg(1),
        data=dict(samples_per_gpu=2, workers_per_gpu=1),
        optimizer=dict(type='SGD', lr=0.01, momentum=0.9),
        lr_config=dict(policy='YOLOX', warmup_iters=2, num_last_epochs=1),
        runner=dict(type='IterBasedRunner', max_iters=3),
        custom_hooks=[dict(type='EMAHook', momentum=0.5),
                      dict(type='ProfilerHook', start=1, stop=2,
                           log_dir=str(prof)),
                      dict(type='MemoryProfilerHook', interval=1),
                      dict(type='SetEpochInfoHook'),
                      dict(type='SyncNormHook'),
                      dict(type='SyncRandomSizeHook')],
        canvases=[(64, 96)], max_gts=4, work_dir=str(tmp_path)))
    torch.manual_seed(0)
    model = build_detector(cfg.model)
    seen = {}
    ema_step = H.EMAHook.after_step

    def record(self, i, state, logs):
        ema_step(self, i, state, logs)
        seen[i] = {k: (v.clone(), p.detach().clone()) for (k, v), p in zip(
            self.ema_params.items(), state.model.parameters())}
    H.EMAHook.after_step = record
    try:
        with caplog.at_level(logging.INFO, logger='boxinstseg_tpu_torch'):
            result = train_detector(model, _TinyBoxDataset(), cfg,
                                    device='cpu')
    finally:
        H.EMAHook.after_step = ema_step
    assert result.step == 3
    assert result.history[0]['lr'] == 0.0
    assert result.history[1]['lr'] == pytest.approx(0.01 * 0.25)
    assert 'lr: 0.000e+00' in (tmp_path / 'train.log').read_text()
    assert all(torch.equal(e, p) for e, p in seen[0].values())
    assert not all(torch.equal(e, p) for e, p in seen[2].values())
    assert (prof / 'trace.json').is_file()
    assert not [r for r in caplog.records if 'GiB in use' in r.getMessage()]
    assert all(math.isfinite(v) for h in result.history for v in h.values())
