"""Every name in the JAX package's registries has a counterpart in the
port's (WAITING, the names still to port, is empty); every backbone and
neck builds in the port with its defaults (on the meta device: shapes
only), and every loss and prior generator with its defaults or the
smallest arguments it takes."""
import pytest
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

import boxinstseg_tpu  # noqa: F401  (registers the JAX modules)
import boxinstseg_tpu.registry as J

import boxinstseg_tpu_torch.registry as T

# registry -> {name: ROADMAP Queue 1 item that ports it}; empty since
# every name of every JAX registry is ported
WAITING = {}
REGISTRIES = sorted(name for name in dir(J)
                    if isinstance(getattr(J, name), J.Registry))


@pytest.mark.parametrize('registry', REGISTRIES)
def test_every_jax_name_is_ported_or_waiting(registry):
    jax_names = set(getattr(J, registry).module_dict)
    port_names = set(getattr(T, registry).module_dict)
    waiting = WAITING.get(registry, {})
    assert jax_names - port_names == set(waiting), (
        'missing from the port and not listed: '
        f'{sorted(jax_names - port_names - set(waiting))}; listed but '
        f'ported: {sorted(set(waiting) & port_names)}')


@pytest.mark.parametrize('registry', ['BACKBONES', 'NECKS'])
def test_every_backbone_and_neck_builds(registry):
    for name in sorted(getattr(J, registry).module_dict):
        with torch.device('meta'):
            module = getattr(T, registry).build(dict(type=name))
        assert isinstance(module, torch.nn.Module), name
        assert sum(p.numel() for p in module.parameters()) > 0, name


# the arguments without a default of the losses and prior generators
BUILD_ARGS = {
    'SeesawLoss': dict(num_classes=4),
    'AnchorGenerator': dict(strides=[8], ratios=[1.0], scales=[4]),
    'LegacyAnchorGenerator': dict(strides=[8], ratios=[1.0], scales=[4]),
    'SSDAnchorGenerator': dict(strides=[8, 16, 32], ratios=[[2]] * 3,
                               min_sizes=[8, 16, 32], max_sizes=[16, 32, 64]),
    'LegacySSDAnchorGenerator': dict(strides=[8] * 6, ratios=[[2]] * 6,
                                     basesize_ratio_range=(0.15, 0.9)),
    'YOLOAnchorGenerator': dict(strides=[8], base_sizes=[[(10, 13)]]),
}


@pytest.mark.parametrize('registry', ['LOSSES', 'PRIOR_GENERATORS'])
def test_every_loss_and_prior_generator_builds(registry):
    for name in sorted(getattr(J, registry).module_dict):
        obj = getattr(T, registry).build(dict(type=name,
                                              **BUILD_ARGS.get(name, {})))
        assert type(obj).__name__ == name
