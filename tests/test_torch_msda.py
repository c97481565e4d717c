"""The port's deformable-attention sampling and its transformer bricks
against the JAX package, on the CPU.

- ``msda_sample_psum_pm``: the value and all four gradients of the port's
  plain version against the JAX function's CPU path (exact fp32 XLA; the
  Pallas d(value) kernel, which rounds to bf16, is TPU-only), with samples
  inside, on the edge of and outside the map; and the plain backward
  against autograd through the plain forward;
- ``MultiScaleDeformableAttention``, the encoder and decoder layers and
  the pixel decoder with the same (perturbed) weights;
- ``interpolate_bilinear`` and ``SinePositionalEncoding``.

Tolerance: atol 1e-5 / rtol 1e-4 (fp32, summation order).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.models.plugins.msdeformattn_pixel_decoder import \
    MSDeformAttnPixelDecoder as JPixelDecoder
from boxinstseg_tpu.models.utils.positional_encoding import \
    SinePositionalEncoding as JSine
from boxinstseg_tpu.models.utils.transformer import (
    DetrTransformerDecoderLayer as JDecoderLayer,
    DetrTransformerEncoderLayer as JEncoderLayer,
    MultiScaleDeformableAttention as JMSDA)
from boxinstseg_tpu.ops.msda_pallas import \
    msda_sample_psum_pm as j_msda
from boxinstseg_tpu.ops.upsample import interpolate_bilinear as j_interp

from boxinstseg_tpu_torch.models.plugins.msdeformattn_pixel_decoder import \
    MSDeformAttnPixelDecoder
from boxinstseg_tpu_torch.models.utils.positional_encoding import \
    SinePositionalEncoding
from boxinstseg_tpu_torch.models.utils.transformer import (
    DetrTransformerDecoderLayer, DetrTransformerEncoderLayer,
    MultiScaleDeformableAttention)
from boxinstseg_tpu_torch.ops import msda
from boxinstseg_tpu_torch.ops.upsample import interpolate_bilinear
from boxinstseg_tpu_torch.utils.weights import params_from_jax

ATOL, RTOL = 1e-5, 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL, msg=''):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), atol=atol,
        rtol=rtol, err_msg=msg)


def msda_inputs(seed, bh=3, h=7, w=9, c=8, p=3, l=11):
    """Samples spread over [-0.4, 1.4]: inside, on the border and outside
    the map (some fully outside, dropped by ``ok``)."""
    rng = np.random.RandomState(seed)
    value = rng.randn(bh, h, w, c).astype(np.float32)
    lx = rng.uniform(-0.4, 1.4, (bh, p * l)).astype(np.float32)
    ly = rng.uniform(-0.4, 1.4, (bh, p * l)).astype(np.float32)
    wt = rng.rand(bh, p * l).astype(np.float32)
    g = rng.randn(bh, l, c).astype(np.float32)
    return value, lx, ly, wt, g, p


@pytest.mark.parametrize('shape', [dict(), dict(h=5, w=4, c=32, p=4, l=6),
                                   dict(bh=2, h=1, w=3, c=3, p=2, l=5)])
def test_msda_value_and_grads_match_jax(shape):
    value, lx, ly, wt, g, p = msda_inputs(0, **shape)
    l = g.shape[1]
    x0 = np.floor(lx * value.shape[2] - 0.5)
    assert (x0 < -1).any() and (x0 > value.shape[2] - 1).any()

    def jfn(v, a, b, c):
        out = j_msda(v, a, b, c, ((l, 1),), p)
        return (out * g).sum(), out

    (_, want), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *map(jnp.asarray, (value, lx, ly, wt)))
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (value, lx, ly, wt)]
    got = msda.msda_sample_psum_pm(*ts, p)
    (got * torch.from_numpy(g)).sum().backward()
    _close(got, want)
    for name, t, jg in zip(('value', 'loc_x', 'loc_y', 'weight'), ts,
                           jgrads):
        _close(t.grad, jg, msg=name)
    assert float(np.abs(jgrads[1]).max()) > 0.1


def test_msda_plain_backward_matches_autograd():
    value, lx, ly, wt, g, p = msda_inputs(1)
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (value, lx, ly, wt)]
    out = msda.msda_forward_plain(*ts, p)
    (out * torch.from_numpy(g)).sum().backward()
    grads = msda.msda_backward_plain(*[torch.from_numpy(a) for a in (
        value, lx, ly, wt, g)], p)
    for t, got in zip(ts, grads):
        _close(got, t.grad)


def _perturb(tree, rng, scale=0.05):
    """Add noise to every leaf so that zero-initialised sampling offsets
    and attention weights (and unit norms) are exercised too."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.randn(*np.shape(a)).astype(
            np.float32), tree)


def _load(module, prefix, jparams):
    """Load a JAX sub-tree into ``module`` through ``params_from_jax`` of
    a whole Box2Mask head tree with that sub-tree at ``prefix``."""
    sd = params_from_jax({'panoptic_head_m': jparams}, {})
    head = 'panoptic_head.' + prefix + '.'
    sub = {k[len(head):]: v for k, v in sd.items() if k.startswith(head)}
    module.load_state_dict(sub, strict=True)
    return module


SHAPES = ((4, 6), (2, 3), (1, 2))


def test_msda_module_matches_jax():
    rng = np.random.RandomState(2)
    c, heads, b = 16, 4, 2
    l = sum(h * w for h, w in SHAPES)
    query = rng.randn(b, l, c).astype(np.float32)
    value = rng.randn(b, l, c).astype(np.float32)
    ref = rng.rand(b, l, 2).astype(np.float32)
    jm = JMSDA(c, heads, 3, 4)
    params = _perturb(jm.init(jax.random.PRNGKey(0), query, value, SHAPES,
                              ref)['params'], rng, 1.0)
    want = jm.apply({'params': params}, query, value, SHAPES, ref)
    tm = MultiScaleDeformableAttention(c, heads, 3, 4)
    tm = _load(tm, 'pixel_decoder.encoder.layers.0.attentions.0',
               {'pixel_decoder': {'encoder_layer_0': {
                   'attn': params, 'ffn': _dummy_ffn(c),
                   'norm1': _dummy_norm(c), 'norm2': _dummy_norm(c)}}})
    got = tm(*map(torch.from_numpy, (query, value)), SHAPES,
             torch.from_numpy(ref))
    _close(got, want)


def _dummy_ffn(c, f=8):
    return {'fc1': {'kernel': np.zeros((c, f), np.float32),
                    'bias': np.zeros(f, np.float32)},
            'fc2': {'kernel': np.zeros((f, c), np.float32),
                    'bias': np.zeros(c, np.float32)}}


def _dummy_norm(c):
    return {'scale': np.ones(c, np.float32), 'bias': np.zeros(c, np.float32)}


def test_encoder_layer_matches_jax():
    rng = np.random.RandomState(3)
    c, heads, b = 16, 4, 2
    l = sum(h * w for h, w in SHAPES)
    x, pos = (rng.randn(b, l, c).astype(np.float32) for _ in range(2))
    ref = rng.rand(b, l, 2).astype(np.float32)
    jm = JEncoderLayer(c, heads, 3, 4, 32)
    params = _perturb(jm.init(jax.random.PRNGKey(1), x, pos, SHAPES,
                              ref)['params'], rng, 0.5)
    want = jm.apply({'params': params}, x, pos, SHAPES, ref)
    tm = _load(DetrTransformerEncoderLayer(c, heads, 3, 4, 32),
               'pixel_decoder.encoder.layers.0',
               {'pixel_decoder': {'encoder_layer_0': params}})
    got = tm(torch.from_numpy(x), torch.from_numpy(pos), SHAPES,
             torch.from_numpy(ref))
    _close(got, want)


def test_decoder_layer_with_mask_matches_jax():
    rng = np.random.RandomState(4)
    c, heads, b, q, lk = 16, 4, 2, 5, 12
    query, qpos = (rng.randn(b, q, c).astype(np.float32) for _ in range(2))
    key, kpos = (rng.randn(b, lk, c).astype(np.float32) for _ in range(2))
    mask = rng.rand(b, heads, q, lk) > 0.5
    mask[..., 0] = False                      # no fully blocked row
    jm = JDecoderLayer(c, heads, 32)
    params = _perturb(jm.init(jax.random.PRNGKey(2), query, key, key, qpos,
                              kpos, mask)['params'], rng, 0.2)
    want = jm.apply({'params': params}, query, key, key, qpos, kpos, mask)
    tm = _load(DetrTransformerDecoderLayer(c, heads, 32),
               'transformer_decoder.layers.0', {'decoder_layer_0': params})
    t = torch.from_numpy
    got = tm(t(query), t(key), t(key), t(qpos), t(kpos), t(mask))
    _close(got, want)


def test_pixel_decoder_matches_jax():
    rng = np.random.RandomState(5)
    chans, hw, b = (8, 16, 24, 32), ((16, 20), (8, 10), (4, 5), (2, 3)), 2
    feats = [rng.randn(b, h, w, ci).astype(np.float32)
             for ci, (h, w) in zip(chans, hw)]
    jm = JPixelDecoder(in_channels=chans, feat_channels=32, out_channels=16,
                       num_encoder_layers=2)
    params = _perturb(jm.init(jax.random.PRNGKey(3), feats)['params'], rng,
                      0.2)
    want_mf, want_outs = jm.apply({'params': params}, feats)
    tm = _load(MSDeformAttnPixelDecoder(in_channels=chans, feat_channels=32,
                                        out_channels=16,
                                        num_encoder_layers=2),
               'pixel_decoder', {'pixel_decoder': params})
    got_mf, got_outs = tm([torch.from_numpy(f).permute(0, 3, 1, 2)
                           for f in feats])
    _close(got_mf.permute(0, 2, 3, 1), want_mf)
    assert len(got_outs) == len(want_outs) == 3
    for g, w in zip(got_outs, want_outs):
        _close(g.permute(0, 2, 3, 1), w)


@pytest.mark.parametrize('src,dst', [(256, 96), (1024, 256), (24, 96),
                                     (37, 24)])
def test_interpolate_bilinear_matches_jax(src, dst):
    rng = np.random.RandomState(src)
    x = rng.randn(2, src, src + 3, 3).astype(np.float32)
    want = j_interp(jnp.asarray(x), (dst, dst + 1))
    got = interpolate_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                               (dst, dst + 1))
    _close(got.permute(0, 2, 3, 1), want)


def test_sine_positional_encoding_matches_jax():
    want = JSine(num_feats=64, normalize=True)(2, 13, 21)
    got = SinePositionalEncoding(num_feats=64)(2, 13, 21)
    assert tuple(got.shape) == (2, 13, 21, 128)
    _close(got, want)
