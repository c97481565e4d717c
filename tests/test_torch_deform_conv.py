"""The port's deformable convolution against the JAX package, on the CPU,
in fp32: ``models.deform_conv.DeformConv2d`` (DCNv1 and DCNv2) and the
SOLO heads' deformable towers.

- The layer's output and its gradients in the input, the offset conv's
  weight and bias and the main weight, against ``jax.grad`` of the JAX
  ``DeformConv2d``, with stride 1 and 2, dilation 1 and 2, and an offset
  conv whose weights put samples between pixels and outside the image
  (the test asserts that some fall outside): atol 1e-5 / rtol 1e-4. At
  init (zero offset branch) DCNv1 is the plain conv and DCNv2 half of it;
- ``ConvModule(conv_type=...)`` builds 'DCN' / 'DCNv2' with mmcv's key
  names and raises on any other type;
- a tiny BoxLevelset with DCNv2 towers and feature convs and a tiny
  DiscoBox with DCN towers (their tests' configs, the offset convs set to
  non-zero weights): the loss dicts at rtol 1e-4.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.engine import init_variables
from boxinstseg_tpu.models.deform_conv import DeformConv2d as JDeform
from boxinstseg_tpu.registry import build_detector as j_build

from boxinstseg_tpu_torch.models.deform_conv import DeformConv2d
from boxinstseg_tpu_torch.models.layers import ConvModule
from boxinstseg_tpu_torch.registry import build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax
from test_torch_backbones_inventory import nchw, projection

ATOL, RTOL = 1e-5, 1e-4
# modulated, stride, dilation
LAYER_CASES = [(False, 1, 1), (True, 2, 2), (False, 2, 2), (True, 1, 2)]


def layer_pair(modulated, stride, dilation, seed=0, cin=5, cout=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 9, 11, cin).astype(np.float32)
    jm = JDeform(cout, 3, stride, dilation, dilation, modulated=modulated)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                   jnp.asarray(x)))
    p = dict(v['params'])
    off_ch = (3 if modulated else 2) * 9
    p['conv_offset'] = dict(
        kernel=rng.randn(3, 3, cin, off_ch).astype(np.float32) * 0.5,
        bias=rng.randn(off_ch).astype(np.float32) * 2.0)
    p['bias'] = rng.randn(cout).astype(np.float32)
    return x, jm, p


def jax_output_and_grads(jm, p, x):
    def loss(p, xx):
        y = jm.apply({'params': p}, xx).transpose(0, 3, 1, 2)
        return (y * projection(y.shape)).sum(), y
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    return np.asarray(y), gp, np.asarray(gx)


def port_layer(p, cin, cout, modulated, stride, dilation):
    """The port's layer with the JAX layer's weights: HWIO -> OIHW, keeping
    the (tap, cin) order of the contraction."""
    tm = DeformConv2d(cin, cout, 3, stride, dilation, dilation,
                      modulated=modulated)
    oihw = lambda k: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
    tm.load_state_dict({
        'weight': oihw(p['kernel']), 'bias': torch.from_numpy(p['bias']),
        'conv_offset.weight': oihw(p['conv_offset']['kernel']),
        'conv_offset.bias': torch.from_numpy(p['conv_offset']['bias'])},
        strict=True)
    return tm


@pytest.mark.parametrize('modulated,stride,dilation', LAYER_CASES)
def test_deform_conv_matches_jax(modulated, stride, dilation):
    x, jm, p = layer_pair(modulated, stride, dilation)
    want, gp, gx = jax_output_and_grads(jm, p, x)
    tm = port_layer(p, 5, 4, modulated, stride, dilation)
    xt = nchw(x).requires_grad_()
    y = tm(xt)
    (y * torch.from_numpy(projection(y.shape))).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx,
                               atol=ATOL, rtol=RTOL)
    for got, key in ((tm.conv_offset.weight.grad, ('conv_offset', 'kernel')),
                     (tm.conv_offset.bias.grad, ('conv_offset', 'bias')),
                     (tm.weight.grad, ('kernel',))):
        node = gp
        for k in key:
            node = node[k]
        node = np.asarray(node)
        if node.ndim == 4:
            node = node.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(got.numpy(), node, atol=ATOL, rtol=RTOL,
                                   err_msg='/'.join(key))
    # the seed puts rows between pixels, some wholly outside the image
    # (their floor corner beyond [-1, H-1]: zero) and most inside
    with torch.no_grad():
        dy = tm.conv_offset(xt)[:, 0:18:2].numpy()      # (B, K, OH, OW)
    rows = np.arange(dy.shape[2]) * stride - dilation
    base = rows[None, :] + (np.arange(9) // 3)[:, None] * dilation
    floor = np.floor(base[None, :, :, None] + dy)
    outside = (floor < -1) | (floor > x.shape[1] - 1)
    assert 0 < outside.mean() < 0.5


@pytest.mark.parametrize('modulated', [False, True])
def test_deform_conv_at_init_is_the_plain_conv(modulated):
    torch.manual_seed(0)
    tm = DeformConv2d(5, 4, 3, 2, 2, 2, modulated=modulated)
    x = torch.randn(2, 5, 9, 11)
    plain = torch.nn.functional.conv2d(x, tm.weight, tm.bias, 2, 2, 2)
    scale = 0.5 if modulated else 1.0
    torch.testing.assert_close(tm(x), scale * plain + (1 - scale) * tm.bias[
        None, :, None, None], rtol=1e-5, atol=1e-6)


def test_conv_module_conv_types():
    for kind, off_ch in (('DCN', 18), ('DCNv2', 27)):
        m = ConvModule(6, 8, 3, 1, 1, norm_cfg=dict(type='GN', num_groups=4),
                       conv_type=kind)
        assert set(m.state_dict()) == {
            'conv.conv_offset.weight', 'conv.conv_offset.bias',
            'conv.weight', 'gn.weight', 'gn.bias'}
        assert m.conv.conv_offset.weight.shape == (off_ch, 6, 3, 3)
        assert m(torch.randn(1, 6, 5, 7)).shape == (1, 8, 5, 7)
    with pytest.raises(ValueError, match='conv type'):
        ConvModule(6, 8, 3, conv_type='DCNv3')


def randomize_offsets(tree, rng, scale=0.05):
    """Every ``conv_offset`` of a params tree set to N(0, scale) weights and
    N(0, 1) biases: offsets of a pixel or so, masks away from 0.5."""
    out = {}
    for k, v in tree.items():
        if k == 'conv_offset':
            out[k] = dict(kernel=rng.randn(*np.shape(v['kernel'])).astype(
                np.float32) * scale, bias=rng.randn(*np.shape(v['bias']))
                .astype(np.float32))
        elif isinstance(v, dict) or hasattr(v, 'items'):
            out[k] = randomize_offsets(v, rng, scale)
        else:
            out[k] = np.asarray(v)
    return out


def model_losses(cfg, batch, kernel_scale, *loss_args):
    """JAX and port loss dicts of a tiny detector from one JAX init, its
    offset convs randomised and its kernel branch's last conv scaled (so
    that the mask scores sit away from 0.5)."""
    jm = j_build(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)}, jb,
                       jnp.zeros((), jnp.int32), method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v['params'] = randomize_offsets(v['params'], np.random.RandomState(3))
    head = v['params']['bbox_head_m']
    head['solo_kernel'] = dict(head['solo_kernel'],
                               kernel=head['solo_kernel']['kernel']
                               * kernel_scale)
    want = jax.jit(lambda v, b: jm.apply(v, b, jnp.zeros((), jnp.int32),
                                         method=jm.loss))(v, jb)
    tm = build_detector(cfg)
    tm.load_state_dict(params_from_jax(v['params'], v.get('batch_stats')),
                       strict=True)
    tb = {k: torch.from_numpy(np.array(x)) for k, x in batch.items()}
    tb['image'] = tb['image'].permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = tm.train().loss(tb, 0, *loss_args)
    return want, got, tm


def assert_losses_match(want, got):
    want = {k: float(x) for k, x in want.items() if k.startswith('loss')}
    got = {k: x.item() for k, x in got.items() if k.startswith('loss')}
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=RTOL, abs=1e-6), k


def test_tiny_boxlevelset_with_dcnv2_towers_matches_jax():
    from test_boxlevelset_model import synth_batch, tiny_cfg
    cfg = tiny_cfg()
    cfg['bbox_head'] = dict(cfg['bbox_head'], use_dcn_in_tower=True,
                            type_dcn='DCNv2')
    batch = {k: np.asarray(x) for k, x in synth_batch(
        np.random.RandomState(1)).items()}
    want, got, tm = model_losses(cfg, batch, 1000.0)
    head = tm.bbox_head
    assert type(head.kernel_convs[0].conv).__name__ == 'DeformConv2d'
    assert head.feature_convs[3].conv2.conv.modulated
    assert_losses_match(want, got)


def test_tiny_discobox_with_dcn_towers_matches_jax():
    from test_discobox_model import synth_batch, tiny_cfg
    cfg = tiny_cfg()
    cfg['bbox_head'] = dict(cfg['bbox_head'], use_dcn_in_tower=True,
                            type_dcn='DCN')
    batch = {k: np.asarray(x) for k, x in synth_batch(
        np.random.RandomState(0)).items()}
    want, got, tm = model_losses(cfg, batch, 30.0)
    assert not tm.bbox_head.cate_convs[0].conv.modulated
    assert_losses_match(want, got)
