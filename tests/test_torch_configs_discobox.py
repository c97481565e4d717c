"""Every shipped DiscoBox config (``configs/discobox/``) in the port
against the JAX package, on the CPU (``tests/torch_config_checks.py``):
the full-width architecture, each parameter's (lr_mult, decay_mult) and
the LR schedule; and the VOC configs' 20-class head on the small DiscoBox
of ``tests/test_discobox_model.py``, its CRF gate open: forward, loss dict
and every gradient against the JAX package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (one torch thread)
from test_discobox_model import synth_batch, tiny_cfg
from test_torch_discobox import KERNEL_SCALE
from torch_config_checks import (check_architecture, check_loss_parity,
                                 check_param_groups, check_schedule,
                                 config_ids, shipped)

from boxinstseg_tpu_torch.config import Config

CONFIGS = shipped('discobox')
VOC = [p for p in CONFIGS if p.endswith('voc_r50_fpn_3x.py')][0]


def test_the_family_ships_four_configs():
    assert len(CONFIGS) == 4


@pytest.mark.parametrize('path', CONFIGS, ids=config_ids(CONFIGS))
def test_architecture_loads_the_jax_variables_strictly(path):
    tm = check_architecture(path)
    assert type(tm).__name__ == 'DiscoBoxSOLOv2'


@pytest.mark.parametrize('path', CONFIGS, ids=config_ids(CONFIGS))
def test_param_groups_match_jax_paramwise(path):
    check_param_groups(path)


@pytest.mark.parametrize('path', CONFIGS, ids=config_ids(CONFIGS))
def test_lr_schedule_matches_jax(path):
    check_schedule(path)


def test_voc_head_matches_jax_forward_loss_and_gradients():
    classes = Config.fromfile(VOC).model.bbox_head.num_classes
    assert classes == 20
    cfg = tiny_cfg()
    cfg['bbox_head'] = dict(cfg['bbox_head'], num_classes=classes)
    batch = {k: np.asarray(v) for k, v in synth_batch(
        np.random.RandomState(0)).items()}
    rng = np.random.RandomState(5)
    batch['gt_labels'] = np.where(batch['gt_valid'], rng.randint(
        0, classes, batch['gt_labels'].shape), 0).astype(np.int32)
    assert batch['gt_labels'].max() >= 4        # beyond the tiny model's 4
    gates = dict(teacher=jnp.float32(0.0), ts=jnp.float32(1.0))
    losses = check_loss_parity(
        cfg, batch, jax_loss_args=(None, gates),
        torch_loss_args=(None, dict(ts=torch.tensor(1.0))),
        scale_kernel=KERNEL_SCALE)
    assert losses['loss_ts'] > 0 and losses['loss_ins'] > 0
