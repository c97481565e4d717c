"""The port's layer-level deformable-attention sampling ``ms_deform_attn``
against the JAX package, on the CPU.

- Its plain version against the sampling core of the JAX
  ``MultiScaleDeformableAttention`` (the loop over levels of
  ``msda_sample_psum_pm``, written out below as the JAX module writes it),
  value and the gradients of value, offsets and attn, at small ragged
  shapes: 2 and 3 levels, 2-4 heads, D 8 and 32, P 2 and 4, samples inside,
  on the edge of and outside every map.
- The gradients of the port's module (inputs and every projection, so
  through value, offsets and attn) against ``jax.grad`` of the JAX module.
- The wrapper's argument checks, which hold on every device.

Tolerance: atol 1e-5 / rtol 1e-4 (fp32, summation order).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.models.utils.transformer import \
    MultiScaleDeformableAttention as JMSDA
from boxinstseg_tpu.ops.msda_pallas import msda_sample_psum_pm as j_msda

from boxinstseg_tpu_torch.models.utils.transformer import \
    MultiScaleDeformableAttention
from boxinstseg_tpu_torch.ops import msda
from boxinstseg_tpu_torch.utils.weights import params_from_jax

ATOL, RTOL = 1e-5, 1e-4
LEVELS3 = ((4, 6), (2, 3), (1, 2))
LEVELS2 = ((4, 6), (2, 3))
# (levels, heads, D, P, queries)
CASES = [(LEVELS3, 2, 8, 2, 11), (LEVELS3, 4, 8, 4, 7),
         (LEVELS2, 3, 32, 4, 9), (LEVELS3, 2, 32, 4, 5),
         (LEVELS2, 4, 8, 2, 13)]


def _close(got, want, msg=''):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), atol=ATOL,
        rtol=RTOL, err_msg=msg)


def layer_inputs(seed, levels, heads, d, p, l, b=2):
    """Reference points in [0, 1]; offsets that put samples up to 0.4 map
    widths outside every level; softmax weights; the output gradient."""
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in levels)
    nl = len(levels)
    size = np.array([[w, h] for h, w in levels], np.float32)[:, None]
    ref = rng.rand(b, l, 2).astype(np.float32)
    loc = rng.uniform(-0.4, 1.4, (b, l, heads, nl, p, 2))
    offsets = ((loc - ref[:, :, None, None, None]) * size).astype(np.float32)
    logits = rng.randn(b, l, heads, nl * p)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return (rng.randn(b, s, heads, d).astype(np.float32), ref, offsets,
            attn.reshape(b, l, heads, nl, p).astype(np.float32),
            rng.randn(b, l, heads * d).astype(np.float32))


def jax_core(value, levels, ref, offsets, attn):
    """The sampling core of the JAX ``MultiScaleDeformableAttention``
    (boxinstseg_tpu/models/utils/transformer.py, after the projections and
    the softmax): per level, heads folded into the batch, P-major samples,
    ``msda_sample_psum_pm``; the levels summed in order."""
    b, s, h, d = value.shape
    l, nl, npnt = ref.shape[1], len(levels), attn.shape[-1]
    ref_x = jnp.tile(ref[..., 0], (1, npnt))               # (b, p*l)
    ref_y = jnp.tile(ref[..., 1], (1, npnt))

    def flat_pm(t):
        """(b, l, h, p) -> (b, h, p*l)."""
        return t.transpose(0, 2, 3, 1).reshape(b, h, npnt * l)

    out = jnp.zeros((b, l, h, d), value.dtype)
    start = 0
    for lvl, (hh, ww) in enumerate(levels):
        vl = value[:, start:start + hh * ww].reshape(b, hh, ww, h, d)
        vl = vl.transpose(0, 3, 1, 2, 4).reshape(b * h, hh, ww, d)
        start += hh * ww
        off_x = flat_pm(offsets[:, :, :, lvl, :, 0])
        off_y = flat_pm(offsets[:, :, :, lvl, :, 1])
        lx = (ref_x[:, None] + off_x / ww).reshape(b * h, -1)
        ly = (ref_y[:, None] + off_y / hh).reshape(b * h, -1)
        w_pm = flat_pm(attn[:, :, :, lvl]).reshape(b * h, -1)
        smp = j_msda(vl, lx, ly, w_pm, ((l, 1),), npnt)
        out = out + smp.reshape(b, h, l, d).transpose(0, 2, 1, 3)
    return out.reshape(b, l, h * d)


@pytest.mark.parametrize('case', CASES)
def test_layer_value_and_grads_match_jax_core(case):
    levels, heads, d, p, l = case
    value, ref, offsets, attn, g = layer_inputs(sum(case[1:]), levels, heads,
                                                d, p, l)
    nl = len(levels)
    x = ref[:, :, None, None, None, 0] + offsets[..., 0] / np.array(
        [w for _, w in levels])[:, None]
    assert ((x < 0) | (x > 1)).any()

    def jfn(v, o, a):
        out = jax_core(v, levels, jnp.asarray(ref), o, a)
        return (out * g).sum(), out

    (_, want), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, (value, offsets, attn)))
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (value, offsets, attn)]
    got = msda.ms_deform_attn(ts[0], levels, torch.from_numpy(ref), ts[1],
                              ts[2])
    assert tuple(got.shape) == (2, l, heads * d)
    (got * torch.from_numpy(g)).sum().backward()
    _close(got, want)
    for name, t, jg in zip(('value', 'offsets', 'attn'), ts, jgrads):
        _close(t.grad, jg, msg=name)
    assert float(np.abs(jgrads[1]).max()) > 0.1
    assert offsets.shape == (2, l, heads, nl, p, 2)


def test_layer_plain_backward_matches_autograd_through_plain_forward():
    value, ref, offsets, attn, g = layer_inputs(7, LEVELS3, 3, 8, 4, 10)
    ref = torch.from_numpy(ref)
    grads = []
    for sample in (msda.PlainMSDAFunction.apply, msda.msda_forward_plain):
        ts = [torch.from_numpy(a).requires_grad_(True)
              for a in (value, offsets, attn)]
        out = msda.ms_deform_attn_plain(ts[0], LEVELS3, ref, ts[1], ts[2],
                                        sample=sample)
        grads.append(torch.autograd.grad(out, ts, torch.from_numpy(g)))
    for got, want in zip(*grads):
        _close(got, want)


def _load(module, jparams):
    """Load a JAX MSDA sub-tree into ``module`` through ``params_from_jax``
    of a Box2Mask head tree holding it as encoder layer 0's attention."""
    c = module.embed_dims
    zeros = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    tree = {'pixel_decoder': {'encoder_layer_0': {
        'attn': jparams,
        'ffn': {'fc1': {'kernel': zeros(c, 8), 'bias': zeros(8)},
                'fc2': {'kernel': zeros(8, c), 'bias': zeros(c)}},
        'norm1': {'scale': np.ones(c, np.float32), 'bias': zeros(c)},
        'norm2': {'scale': np.ones(c, np.float32), 'bias': zeros(c)}}}}
    sd = params_from_jax({'panoptic_head_m': tree}, {})
    head = 'panoptic_head.pixel_decoder.encoder.layers.0.attentions.0.'
    module.load_state_dict({k[len(head):]: v for k, v in sd.items()
                            if k.startswith(head)}, strict=True)
    return module


# (levels, heads, D, P): the encoder's own queries (L = S)
@pytest.mark.parametrize('case', [(LEVELS3, 2, 8, 4), (LEVELS2, 4, 8, 2),
                                  (LEVELS3, 2, 32, 2)])
def test_module_grads_match_jax(case):
    levels, heads, d, p = case
    rng = np.random.RandomState(heads * d + p)
    c, b, nl = heads * d, 2, len(levels)
    l = sum(h * w for h, w in levels)
    query = rng.randn(b, l, c).astype(np.float32)
    value = rng.randn(b, l, c).astype(np.float32)
    ref = rng.rand(b, l, 2).astype(np.float32)
    g = rng.randn(b, l, c).astype(np.float32)
    jm = JMSDA(c, heads, nl, p)
    params = jm.init(jax.random.PRNGKey(0), query, value, levels,
                     ref)['params']
    # perturbed so that the zero-initialised offset and weight projections
    # are exercised, at a scale that keeps the gradients O(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*np.shape(a)).astype(
            np.float32), params)

    def jfn(prm, q, v):
        return (jm.apply({'params': prm}, q, v, levels, ref) * g).sum()

    jgp, jgq, jgv = jax.grad(jfn, argnums=(0, 1, 2))(
        params, jnp.asarray(query), jnp.asarray(value))
    tm = _load(MultiScaleDeformableAttention(c, heads, nl, p), params)
    tq, tv = (torch.from_numpy(a).requires_grad_(True)
              for a in (query, value))
    out = tm(tq, tv, levels, torch.from_numpy(ref))
    (out * torch.from_numpy(g)).sum().backward()
    _close(tq.grad, jgq, msg='query')
    _close(tv.grad, jgv, msg='value')
    for name in ('value_proj', 'sampling_offsets', 'attention_weights',
                 'output_proj'):
        lin = getattr(tm, name)
        _close(lin.weight.grad.T, jgp[name]['kernel'], msg=name)
        _close(lin.bias.grad, jgp[name]['bias'], msg=name)
    assert float(np.abs(jgp['sampling_offsets']['kernel']).max()) > 0.1


def _args(**change):
    value, ref, offsets, attn, _ = layer_inputs(9, LEVELS3, 2, 8, 2, 5)
    args = dict(value=torch.from_numpy(value), spatial_shapes=LEVELS3,
                reference_points=torch.from_numpy(ref),
                offsets=torch.from_numpy(offsets),
                attn=torch.from_numpy(attn))
    args.update(change)
    return args


@pytest.mark.parametrize('change,match', [
    (lambda a: dict(value=a['value'][0]), r'\(B, S, heads, D\)'),
    (lambda a: dict(spatial_shapes=((4, 6), (2, 3))), 'do not tile'),
    (lambda a: dict(spatial_shapes=((4, 6), (2, 3), (1, 3))), 'do not tile'),
    (lambda a: dict(reference_points=a['reference_points'][..., :1]
                    .contiguous()), r'\(B, L, 2\)'),
    (lambda a: dict(offsets=a['offsets'][:, :, :, :2].contiguous()),
     'offsets must be'),
    (lambda a: dict(attn=a['attn'][..., :1].contiguous()), 'attn'),
    (lambda a: dict(offsets=a['offsets'].transpose(1, 2).contiguous()
                    .transpose(1, 2)), 'contiguous'),
    (lambda a: dict(value=a['value'].double()), 'float32'),
    (lambda a: dict(reference_points=a['reference_points']
                    .clone().requires_grad_(True)), 'must not require grad'),
])
def test_ms_deform_attn_rejects_what_it_does_not_take(change, match):
    with pytest.raises(ValueError, match=match):
        msda.ms_deform_attn(**_args(**change(_args())))


def test_per_level_sampler_names_the_layer_call_off_the_cpu():
    value, lx, ly, wt = (torch.empty(s, device='meta') for s in (
        (2, 3, 4, 8), (2, 10), (2, 10), (2, 10)))
    with pytest.raises(ValueError, match='ms_deform_attn'):
        msda.msda_sample_psum_pm(value, lx, ly, wt, 2)
