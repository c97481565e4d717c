"""Every shipped BoxInst config (``configs/boxinst/``) in the port against
the JAX package, on the CPU (``tests/torch_config_checks.py``): the
full-width architecture (a strict load of the JAX variables' shapes), each
parameter's (lr_mult, decay_mult) and the LR schedule. ResNet-101's
``init_cfg`` (``Pretrained``, ``torchvision://resnet101``) loads nothing
and raises nothing, as in the JAX package: the port loads a backbone only
through ``tools/train_torch.py --pretrained-backbone``.
"""
import urllib.request

import pytest
import torch

import test_torch_threads  # noqa: F401  (one torch thread)
from torch_config_checks import (check_architecture, check_param_groups,
                                 check_schedule, config_ids, shipped)

from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.registry import build_backbone

CONFIGS = shipped('boxinst')


def test_the_family_ships_seven_configs():
    assert len(CONFIGS) == 7


@pytest.mark.parametrize('path', CONFIGS, ids=config_ids(CONFIGS))
def test_architecture_loads_the_jax_variables_strictly(path):
    tm = check_architecture(path)
    assert type(tm).__name__ == 'CondInst'


@pytest.mark.parametrize('path', CONFIGS, ids=config_ids(CONFIGS))
def test_param_groups_match_jax_paramwise(path):
    assert (1.0, 1.0) in check_param_groups(path)


@pytest.mark.parametrize('path', CONFIGS, ids=config_ids(CONFIGS))
def test_lr_schedule_matches_jax(path):
    check_schedule(path)


def test_pretrained_init_cfg_loads_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('a backbone build reached for the network')
    monkeypatch.setattr(urllib.request, 'urlopen', refuse)
    monkeypatch.setattr(torch.hub, 'load_state_dict_from_url', refuse)
    bb = Config.fromfile(CONFIGS[0]).model.backbone     # ResNet-101 1x
    assert bb.depth == 101 and bb.init_cfg == dict(
        type='Pretrained', checkpoint='torchvision://resnet101')
    built = []
    for cfg in (bb, {k: v for k, v in bb.items() if k != 'init_cfg'}):
        torch.manual_seed(0)
        built.append(build_backbone(dict(cfg)).state_dict())
    assert built[0].keys() == built[1].keys()
    for k, v in built[0].items():
        assert torch.equal(v, built[1][k]), k
