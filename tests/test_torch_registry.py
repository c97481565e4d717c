"""Every name in the JAX package's registries has a counterpart in the
port's, but for the names still waiting, each listed with its ROADMAP
item; every backbone and neck builds in the port with its defaults (on
the meta device: shapes only). A name leaves WAITING in the slice that
ports it: the test fails while a listed name is registered in the port."""
import pytest
import torch

import boxinstseg_tpu  # noqa: F401  (registers the JAX modules)
import boxinstseg_tpu.registry as J

import boxinstseg_tpu_torch.registry as T

# registry -> {name: ROADMAP Queue 1 item that ports it}
WAITING = {
    'LOSSES': {**{n: '8.4' for n in (
        'AssociativeEmbeddingLoss', 'BalancedL1Loss', 'BoundedIoULoss',
        'CIoULoss', 'DIoULoss', 'DistributionFocalLoss', 'GHMC', 'GHMR',
        'GaussianFocalLoss', 'IoULoss', 'KnowledgeDistillationKLDivLoss',
        'L1Loss', 'MSELoss', 'QualityFocalLoss', 'SeesawLoss',
        'SmoothL1Loss', 'VarifocalLoss')}},
    'PRIOR_GENERATORS': {n: '8.3' for n in (
        'AnchorGenerator', 'LegacyAnchorGenerator',
        'LegacySSDAnchorGenerator', 'SSDAnchorGenerator',
        'YOLOAnchorGenerator')},
}
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
