"""The port's ResNeXt, ResNetV1d, ResNeSt, DetectoRS_ResNet and PVT v1 / v2
against the JAX package, on the CPU, in fp32.

Each backbone is built from the same config in both packages at
``num_stages=2`` and tiny widths, its JAX variables perturbed from their
init (frozen-BN statistics, zero-initialised branches such as the
SAConv's ``weight_diff`` and the RFP conv) so that every parameter counts,
and converted with ``params_from_jax``, loaded with ``strict=True``. The
outputs and the input image's gradient (of a fixed projection of the
outputs) agree within atol 1e-5 / rtol 1e-4 at 64x64, and for the
backbones with pools or spatial reduction at a second size: odd pooled
maps for the V1d shortcut's ``ceil_mode`` pool and ResNeSt's pools, maps
that ``sr_ratio`` does not divide for PVT. ``load_pretrained_backbone``
reads a saved backbone back from a detector checkpoint. ROADMAP F9 (the
JAX ResNeSt against mmdet's) is pinned here.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.registry import BACKBONES as J_BACKBONES

from boxinstseg_tpu_torch.registry import BACKBONES
from boxinstseg_tpu_torch.utils.weights import (load_pretrained_backbone,
                                                params_from_jax)

ATOL, RTOL = 1e-5, 1e-4

TINY_PVT = dict(embed_dims=(16, 32), num_stages=2, num_layers=(1, 2),
                num_heads=(1, 2), sr_ratios=(8, 4), mlp_ratios=(2, 2),
                out_indices=(0, 1))

CASES = {
    'ResNeXt': dict(type='ResNeXt', depth=50, num_stages=2, groups=4,
                    base_width=4, out_indices=(0, 1)),
    'ResNetV1d': dict(type='ResNetV1d', depth=50, num_stages=2,
                      stem_channels=32, out_indices=(0, 1)),
    'ResNetV1d-18': dict(type='ResNetV1d', depth=18, num_stages=2,
                         out_indices=(0, 1)),
    'ResNeSt': dict(type='ResNeSt', depth=50, num_stages=2, groups=2,
                    base_width=16, stem_channels=32, out_indices=(0, 1)),
    'DetectoRS_ResNet': dict(type='DetectoRS_ResNet', depth=50,
                             num_stages=2, out_indices=(0, 1),
                             rfp_inplanes=8, output_img=True,
                             sac=dict(type='SAC', use_deform=False)),
    'PyramidVisionTransformer': dict(type='PyramidVisionTransformer',
                                     **TINY_PVT),
    'PyramidVisionTransformerV2': dict(type='PyramidVisionTransformerV2',
                                       **TINY_PVT),
}
# the second input of the backbones with pools or spatial reduction: odd
# pooled maps for the V1d shortcut (69x75: 18x19 into the stride-2 stage),
# even maps into ResNeSt's stride-2 blocks that its pools make odd (88x72:
# 22x18 -> 11x9), maps that sr_ratio does not divide (72x88: 18x22 and
# 9x11 tokens)
ODD = {'ResNetV1d': (69, 75), 'ResNeSt': (88, 72),
       'PyramidVisionTransformer': (72, 88),
       'PyramidVisionTransformerV2': (72, 88)}
SIZES = [(name, '64x64') for name in CASES] + [(name, 'odd') for name in ODD]


def perturb(tree, rng, scale=0.1):
    """Every array of a variables tree moved by noise: an array drawn at
    init by 2 x scale of its own spread, a constant one (BN scales and
    statistics, biases, zero-initialised branches) by scale x N(0, 1); BN
    variances drawn from U(0.5, 1.5). The activations keep the size
    that the init gives them."""
    def walk(node, name=''):
        if isinstance(node, dict) or hasattr(node, 'items'):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if name == 'var':
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        spread = 2 * a.std() if a.std() > 0 else 1.0
        return (a + scale * spread * rng.randn(*a.shape)).astype(np.float32)
    return walk(tree)


def strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def rfp_feats(cfg, x, rng):
    """Stage-sized RFP features (channels ``rfp_inplanes``) for
    DetectoRS: stage s has stride 4 * 2**s (NHWC)."""
    b, h, w, _ = x.shape
    feats, hs, ws = [], -(-h // 4), -(-w // 4)
    for s in range(cfg['num_stages']):
        feats.append(rng.randn(b, hs, ws, cfg['rfp_inplanes'])
                     .astype(np.float32))
        hs, ws = -(-hs // 2), -(-ws // 2)
    return feats


def jax_backbone(cfg, x, rng, extra):
    jm = J_BACKBONES.build(dict(cfg))
    v = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), *extra)))
    v = perturb(v, rng)
    if cfg['type'] == 'DetectoRS_ResNet':
        # the weight-standardised SAConv multiplies by about sqrt(fan-in);
        # its BN's variances absorb that, as trained statistics would
        for name, node in v['params'].items():
            if 'conv2' in node:
                fan_in = np.prod(node['conv2']['weight'].shape[:3])
                v['batch_stats'][name]['bn2']['var'] *= fan_in
    return jm, v


def projection(shape):
    """A fixed (B, C, H, W) weight of an output: the loss whose input
    gradient the tests compare is the sum of the weighted outputs."""
    n = int(np.prod(shape))
    return np.cos(0.37 * np.arange(n, dtype=np.float32)).reshape(shape)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x,
                                                              (0, 3, 1, 2))))


def run_pair(name, hw, seed=0):
    """JAX and port outputs (NCHW numpy) and input gradients (NHWC) of one
    backbone case at ``hw``, and the port's backbone."""
    cfg = CASES[name]
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *hw, 3).astype(np.float32)
    extra = ([jnp.asarray(f) for f in rfp_feats(cfg, x, rng)],) \
        if 'rfp_inplanes' in cfg else ()
    jm, v = jax_backbone(cfg, x, rng, extra)

    def loss(xx):
        ys = [y.transpose(0, 3, 1, 2) for y in jm.apply(v, xx, *extra)]
        return sum((y * projection(y.shape)).sum() for y in ys), ys
    (_, outs), gx = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(x))

    tm = BACKBONES.build(dict(cfg))
    tm.load_state_dict(strip(params_from_jax(
        {'backbone_m': v['params']},
        {'backbone_m': v.get('batch_stats', {})}), 'backbone.'),
        strict=True)
    xt = nchw(x).requires_grad_()
    touts = tm(xt, *[[nchw(np.asarray(f)) for f in e] for e in extra])
    sum((y * torch.from_numpy(projection(y.shape))).sum()
        for y in touts).backward()
    return ([np.asarray(o) for o in outs], [o.detach().numpy() for o in touts],
            np.asarray(gx), xt.grad.permute(0, 2, 3, 1).numpy(), tm)


@pytest.mark.parametrize('name,hw', SIZES)
def test_backbone_matches_jax(name, hw):
    size = (64, 64) if hw == '64x64' else ODD[name]
    jo, to, jg, tg, _ = run_pair(name, size)
    assert len(jo) == len(to)
    for a, b in zip(jo, to):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tg, jg, atol=ATOL, rtol=RTOL)


def test_v1d_names_are_mmdets():
    tm = BACKBONES.build(dict(type='ResNetV1d', depth=50))
    keys = set(tm.state_dict())
    assert {f'stem.{i}.weight' for i in (0, 1, 3, 4, 6, 7)} <= keys
    assert 'layer2.0.downsample.1.weight' in keys
    assert 'layer2.0.downsample.2.running_var' in keys
    assert isinstance(tm.layer2[0].downsample[0], torch.nn.AvgPool2d)
    assert tm.layer1[0].conv2.groups == 1
    x = BACKBONES.build(dict(type='ResNeXt', depth=101, groups=64,
                             base_width=4))
    assert x.layer1[0].conv2.groups == 64
    assert x.layer1[0].conv2.weight.shape == (256, 4, 3, 3)


@pytest.mark.parametrize('hw', [(7, 9), (8, 8), (1, 5)])
def test_avg_pool_ceil_matches_jax(hw):
    """The V1d shortcut pool at odd and even sizes, against the JAX
    ``_avg_pool_ceil``."""
    from boxinstseg_tpu.models.backbones.resnet import _avg_pool_ceil
    from boxinstseg_tpu_torch.models.backbones.resnet import avg_pool_ceil
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(_avg_pool_ceil(jnp.asarray(x), 2, 2))
    got = avg_pool_ceil(2)(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_jax_resnest_departs_from_mmdet_pins_f9():
    """ROADMAP F9: the JAX ResNeSt's bottleneck is int(planes * base_width
    / 64) * groups wide at groups 1 (4 at stage 0 with the defaults, where
    mmdet's is planes, 64), and its stride-2 shortcut pool rounds down, so
    a stride-2 block fails on an odd map (mmdet's ceil_mode pool takes
    it). This holds while that stands; were the JAX package repaired, the
    width would be 64 and the odd map would run. The port follows JAX."""
    jm = J_BACKBONES.build(dict(type='ResNeSt', depth=50, num_stages=2))
    x = jnp.zeros((1, 64, 64, 3))
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    width = v['params']['layer1_0']['conv1']['kernel'].shape[-1]
    tm = BACKBONES.build(dict(type='ResNeSt', depth=50, num_stages=2))
    assert tm.layer1[0].conv1.weight.shape[0] == width
    odd = jnp.zeros((1, 100, 100, 3))      # a 25x25 map into stage 2
    try:
        jax.eval_shape(jm.apply, v, odd)
    except (TypeError, ValueError) as err:
        assert width == 4, width
        assert 'shapes' in str(err) or 'broadcast' in str(err)
        with pytest.raises(RuntimeError):
            tm(torch.zeros(1, 3, 100, 100))
        return
    assert width == 64


def test_detectors_raises_on_deformable_sac():
    with pytest.raises(ValueError, match='use_deform'):
        BACKBONES.build(dict(type='DetectoRS_ResNet', depth=50,
                             sac=dict(type='SAC', use_deform=True)))


@pytest.mark.parametrize('name', ['ResNetV1d', 'PyramidVisionTransformerV2',
                                  'DetectoRS_ResNet'])
def test_pretrained_backbone_file_round_trip(name, tmp_path):
    """A detector checkpoint (``backbone.`` keys, BN counters, a
    classifier, another module's keys) loads through
    ``load_pretrained_backbone`` and gives the saved backbone's forward; a
    file of another backbone raises."""
    torch.manual_seed(0)
    tm = BACKBONES.build(dict(CASES[name])).eval()
    sd = {f'backbone.{k}': v for k, v in tm.state_dict().items()}
    sd['backbone.fc.weight'] = torch.zeros(3, 3)
    sd['backbone.layer1.0.bn1.num_batches_tracked'] = torch.tensor(0)
    sd['neck.lateral_convs.0.conv.weight'] = torch.zeros(3, 3)
    path = tmp_path / 'ckpt.pth'
    torch.save({'state_dict': sd}, path)
    torch.manual_seed(1)
    fresh = BACKBONES.build(dict(CASES[name])).eval()
    load_pretrained_backbone(fresh, str(path))
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 64, 64)
                         .astype(np.float32))
    for a, b in zip(fresh(x), tm(x)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    other = BACKBONES.build(dict(type='ResNet', depth=18))
    with pytest.raises((KeyError, RuntimeError)):
        load_pretrained_backbone(other, str(path))
