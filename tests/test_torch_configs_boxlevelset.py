"""Every shipped BoxLevelset config (``configs/boxlevelset/``) in the port
against the JAX package, on the CPU (``tests/torch_config_checks.py``):
the full-width architecture, each parameter's (lr_mult, decay_mult) and
the LR schedule; and ``box_levelset_voc_r50_fpn_1x_640``'s head (its SOLO
grids [40, 36, 24, 16, 12], its scale ranges, 20 classes) on the small
model of ``tests/test_torch_boxlevelset.py``: forward, loss dict and every
gradient against the JAX package.
"""
import numpy as np
import pytest

import test_torch_threads  # noqa: F401  (one torch thread)
from test_torch_boxlevelset import KERNEL_SCALE, cfg_with, make_batch
from torch_config_checks import (check_architecture, check_loss_parity,
                                 check_param_groups, check_schedule,
                                 config_ids, shipped)

from boxinstseg_tpu_torch.config import Config

CONFIGS = shipped('boxlevelset')
VOC_640 = [p for p in CONFIGS if p.endswith('voc_r50_fpn_1x_640.py')][0]


def test_the_family_ships_five_configs():
    assert len(CONFIGS) == 5


@pytest.mark.parametrize('path', CONFIGS, ids=config_ids(CONFIGS))
def test_architecture_loads_the_jax_variables_strictly(path):
    tm = check_architecture(path)
    assert type(tm).__name__ == 'BoxLevelSet'


@pytest.mark.parametrize('path', CONFIGS, ids=config_ids(CONFIGS))
def test_param_groups_match_jax_paramwise(path):
    check_param_groups(path)


@pytest.mark.parametrize('path', CONFIGS, ids=config_ids(CONFIGS))
def test_lr_schedule_matches_jax(path):
    check_schedule(path)


def test_voc_640_head_matches_jax_forward_loss_and_gradients():
    head = Config.fromfile(VOC_640).model.bbox_head
    assert list(head.num_grids) == [40, 36, 24, 16, 12]
    cfg = cfg_with(64)
    cfg['bbox_head'] = dict(cfg['bbox_head'], num_classes=head.num_classes,
                            num_grids=list(head.num_grids),
                            scale_ranges=head.scale_ranges)
    batch = make_batch(1)
    rng = np.random.RandomState(5)
    batch['gt_labels'] = np.where(batch['gt_valid'], rng.randint(
        0, head.num_classes, batch['gt_labels'].shape), 0).astype(np.int32)
    assert batch['gt_labels'].max() >= 4        # beyond the tiny model's 4
    losses = check_loss_parity(cfg, batch, scale_kernel=KERNEL_SCALE)
    assert set(losses) == {'loss_cate', 'loss_boxpro', 'loss_levelset'}
    assert all(v > 0 for v in losses.values())
