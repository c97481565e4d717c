"""Every shipped Box2Mask config (``configs/box2mask/``) in the port
against the JAX package, on the CPU (``tests/torch_config_checks.py``):
the full-width architecture, each parameter's (lr_mult, decay_mult) and
the LR schedule. Forward, loss dict and every gradient against the JAX
package, under the VOC configs' head (20 thing classes and the config's
own ``class_weight`` of 21, the no-object class last), on two small
models:

- the small ResNet-18 Box2Mask of ``tests/test_box2mask_model.py``, whose
  transformers' FFN ReLUs follow the JAX package's pre-activation signs:
  where the two packages' pre-activations straddle 0 (within the forward
  check's tolerance; one element of encoder layer 1's 2 x 336 x 1024 FFN
  map on this batch), a gate in the port opens as the JAX one does
  (T2 in ROADMAP: with the port's own gate the gradients upstream of that
  FFN move by more than the tolerance); the ties are printed;
- the small Swin Box2Mask of ``tests/test_torch_swin.py`` at Swin-T's
  window 7, whose 32, 16 and 8 token maps of a 128x128 image 7 does not
  divide (padded to whole windows, every second block shifted, N = 49;
  the JAX package computes this shape in XLA).

F11 pinned: a Box2Mask config's test pipeline resizes to 1333x800, which
its 1024x1024 canvas does not hold; the JAX package's evaluation batches
with the config's canvases alone and raises, the port's ``eval_batcher``
adds the test pipeline's canvases.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_threads  # noqa: F401  (one torch thread)
from test_box2mask_model import synth_batch, tiny_cfg
from test_torch_swin import swin_box2mask_cfg
from torch_config_checks import (check_architecture, check_loss_parity,
                                 check_param_groups, check_schedule,
                                 close_scaled, config_ids, shipped, ATOL,
                                 RTOL)

from boxinstseg_tpu.config import Config as JConfig
from boxinstseg_tpu.data.batcher import StaticBatcher as JStaticBatcher

from boxinstseg_tpu_torch.apis.test import eval_batcher
from boxinstseg_tpu_torch.config import Config

CONFIGS = shipped('box2mask')
VOC = [p for p in CONFIGS if p.endswith('r50_lsj_8x2_50e_voc.py')][0]
SWIN_T = [p for p in CONFIGS if 'swin-t' in p][0]


def test_the_family_ships_six_configs():
    assert len(CONFIGS) == 6


@pytest.mark.parametrize('path', CONFIGS, ids=config_ids(CONFIGS))
def test_architecture_loads_the_jax_variables_strictly(path):
    tm = check_architecture(path)
    assert type(tm).__name__ == 'Box2Mask'


@pytest.mark.parametrize('path', CONFIGS, ids=config_ids(CONFIGS))
def test_param_groups_match_jax_paramwise(path):
    kinds = check_param_groups(path)
    assert {(0.1, 1.0), (1.0, 0.0), (1.0, 1.0)} <= kinds


@pytest.mark.parametrize('path', CONFIGS, ids=config_ids(CONFIGS))
def test_lr_schedule_matches_jax(path):
    check_schedule(path)


def _batch(seed, classes):
    batch = {k: np.asarray(v) for k, v in synth_batch(
        np.random.RandomState(seed)).items()}
    rng = np.random.RandomState(5)
    batch['gt_labels'] = np.where(batch['gt_valid'], rng.randint(
        0, classes, batch['gt_labels'].shape), 0).astype(np.int32)
    return batch


def _voc_head(cfg):
    """``cfg`` under the VOC configs' head; returns (cfg, classes)."""
    head = Config.fromfile(VOC).model.panoptic_head
    classes, weight = head.num_things_classes, head.loss_cls.class_weight
    assert classes == 20 and len(weight) == classes + 1
    cfg['panoptic_head'] = dict(
        cfg['panoptic_head'], num_things_classes=classes,
        loss_cls=dict(cfg['panoptic_head']['loss_cls'],
                      class_weight=list(weight)))
    return cfg, classes


class JaxSignReLU(torch.nn.Module):
    """An FFN's ReLU gated by the JAX package's pre-activations
    (``jax_pre``): the port's pre-activations are first held to them at
    the forward tolerance, so that a gate the two read differently is one
    whose pre-activation both put within that tolerance of 0; each such
    element is kept in ``ties`` as (flat index, port value, JAX value)."""

    def __init__(self, name, jax_pre):
        super().__init__()
        self.name, self.jax_pre = name, jax_pre
        self.gate = torch.from_numpy(jax_pre > 0)
        self.ties = set()
        self.follow = True        # False: the port's own ReLU

    def forward(self, x):
        if not self.follow:
            return torch.relu(x)
        pre = x.detach().numpy()
        close_scaled(pre, self.jax_pre, f'{self.name} pre-activation')
        for i in np.flatnonzero((pre > 0) != self.gate.numpy()):
            self.ties.add((int(i), float(pre.flat[i]),
                           float(self.jax_pre.flat[i])))
        return x * self.gate


def follow_jax_relu_signs(gates):
    """A ``check_loss_parity`` ``prepare``: each FFN ReLU of the port's
    pixel-decoder encoder and transformer decoder replaced by a
    ``JaxSignReLU`` on the JAX package's fc1 outputs of the same loss
    (``capture_intermediates``); the gates are appended to ``gates``."""
    def prepare(jm, v, jb, tm):
        _, state = jax.jit(lambda v, b: jm.apply(
            v, b, jnp.zeros((), jnp.int32), method=jm.loss,
            capture_intermediates=lambda mdl, _: mdl.name == 'fc1',
            mutable=['intermediates']))(v, jb)
        head = state['intermediates']['panoptic_head_m']
        found = [(f'pixel_decoder.encoder.layers.{i}',
                  head['pixel_decoder'][k]['ffn']['fc1']['__call__'])
                 for k, i in _numbered(head['pixel_decoder'],
                                       'encoder_layer')]
        found += [(f'transformer_decoder.layers.{i}',
                   head[k]['ffn']['fc1']['__call__'])
                  for k, i in _numbered(head, 'decoder_layer')]
        assert len(found) == 5                  # 2 encoder, 3 decoder layers
        for path, calls in found:
            assert len(calls) == 1
            ffn = tm.panoptic_head.get_submodule(path).ffns[0]
            gate = JaxSignReLU(path, np.asarray(calls[0]))
            ffn.layers[0][1] = gate
            gates.append(gate)
    return prepare


def _numbered(tree, stem):
    return [(k, int(m.group(1))) for k in tree
            if (m := re.fullmatch(stem + r'_(\d+)', k))]


def test_voc_head_on_resnet_matches_jax_at_its_relu_signs():
    """The VOC configs' 20 classes and class_weight on the ResNet-18
    Box2Mask: forward, loss dict and every gradient, the FFN ReLUs gated
    as the JAX package's (T2)."""
    cfg, classes = _voc_head(tiny_cfg())
    batch = _batch(2, classes)
    assert batch['gt_labels'].max() >= 4        # beyond the tiny model's 4
    gates, out = [], {}
    losses = check_loss_parity(cfg, batch, grads_out=out,
                               prepare=follow_jax_relu_signs(gates))
    assert 'd2.loss_levelset' in losses and losses['loss_cls'] > 0
    ties = {g.name: sorted(g.ties) for g in gates if g.ties}
    print('\nFFN ReLU pre-activations the packages read on either side of '
          '0 (flat index, port, JAX):', ties)
    # what the port's own gates give: each leaf's largest gap over the
    # tolerance, printed (not checked: the ties depend on summation order)
    tm = out['model']
    for g in gates:
        g.follow = False
    tm.zero_grad()
    sum(x for k, x in tm.loss(out['batch'], 0).items()
        if 'loss' in k).backward()
    for k, p in tm.named_parameters():
        want = out['grads'][k].numpy()
        tol = ATOL * max(np.abs(want).max(), 1.0) + RTOL * np.abs(want)
        worst = float((np.abs(p.grad.numpy() - want) / tol).max())
        if worst > 1:
            print(f'port ReLU: {k} gap {worst:.3f} x the tolerance')


def test_voc_head_on_swin_t_window_7_matches_jax():
    """The VOC configs' 20 classes and class_weight and Swin-T's window 7
    in one small model: forward, loss dict and every gradient."""
    bb = Config.fromfile(SWIN_T).model.backbone
    assert (bb.window_size, bb.embed_dims) == (7, 96)
    cfg = swin_box2mask_cfg()
    cfg['backbone'] = dict(cfg['backbone'], window_size=bb.window_size)
    cfg, classes = _voc_head(cfg)
    batch = _batch(2, classes)
    assert batch['image'].shape[1:3] == (128, 128)   # maps 32, 16, 8, 4
    assert batch['gt_labels'].max() >= 4        # beyond the tiny model's 4
    losses = check_loss_parity(cfg, batch)
    assert 'd2.loss_levelset' in losses and losses['loss_cls'] > 0


@pytest.mark.parametrize('shape', [(800, 1344), (1344, 800)])
def test_test_images_fit_the_eval_canvases_pins_f11(shape):
    path = [p for p in CONFIGS if p.endswith('r50_lsj_8x2_50e_coco.py')][0]
    h, w = shape                 # a 1333x800 Resize padded to 32
    sample = dict(img=np.zeros((h, w, 3), np.float32), ori_shape=(h, w, 3),
                  scale_factor=np.ones(4, np.float32))
    jcfg = JConfig.fromfile(path)
    assert jcfg.canvases == [(1024, 1024)]
    with pytest.raises(ValueError, match='does not fit any canvas'):
        # the JAX run_evaluation's batcher: the config's canvases alone
        JStaticBatcher(canvases=jcfg.canvases, max_gts=1)([sample])
    batch = eval_batcher(Config.fromfile(path))([sample])
    assert batch['image'].shape == (1, h, w, 3)
    square = dict(sample, img=np.zeros((1024, 1024, 3), np.float32))
    assert eval_batcher(Config.fromfile(path))([square])['image'].shape \
        == (1, 1024, 1024, 3)
