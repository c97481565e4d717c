"""The port's Swin window attention, Swin backbone, Swin Box2Mask and
Box2Mask predict against the JAX package, on the CPU.

- ``window_attention`` (the plain forward and its explicit backward)
  against the JAX ``window_attention`` with its Pallas kernels K5/K6 run
  in interpret mode: shifted regions, all-zero regions, N = 16, 49, 196
  and 256 (the last two shifted, at head dim 32), and two images a call
  (BW = 2 nW, the ``bw % nW`` region rows). Forward
  atol/rtol 1e-5 / 1e-4; the four gradients 3e-4, the bound the JAX
  package's own interpret-mode test uses.
- ``SwinTransformer`` against the JAX one with the same weights
  (``params_from_jax``): every stage's output, and the gradients of a
  scalar of the outputs with respect to the input and every parameter, on
  a 40x56 input whose token maps need padding and whose last two stages
  are smaller than the window (the ``min(ws, h, w)`` rule and its dropped
  shift), with no stage frozen and with two (``frozen_stages=2``, the JAX
  ``stop_gradient``). atol 1e-5 / rtol 1e-4 on outputs; gradients atol
  1e-5 of their largest entry and rtol 1e-4.
- ``params_from_jax`` -> ``convert_reference_checkpoint`` gives back the
  JAX params of a tiny Swin Box2Mask exactly (PatchMerging's channel
  permutation inverted).
- The tiny Box2Mask of ``tests/test_box2mask_model.py`` on a tiny Swin:
  its loss dict, every ``d{i}.*`` key (rtol 1e-4), and the gradient of
  every backbone parameter against one compiled ``jax.value_and_grad``.
  The batch is seed 2: on seed 1 the compiled JAX gradient differs from
  JAX's own eager one by up to 2.8% of a tensor's largest entry (an
  encoder FFN input of that batch sits within 1e-6 of the ReLU's kink),
  while the eager one agrees with the port to 1e-5.
- ``MaskFormer.predict`` and ``panoptic_postprocess`` against the JAX ones.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.models.backbones.swin import \
    SwinTransformer as JSwinTransformer
from boxinstseg_tpu.models.detectors.maskformer import \
    panoptic_postprocess as j_panoptic_postprocess
from boxinstseg_tpu.ops import swin_attention as swa
from boxinstseg_tpu.engine import init_variables
from boxinstseg_tpu.registry import build_detector as j_build
from boxinstseg_tpu.utils.checkpoint_convert import \
    convert_reference_checkpoint
from test_box2mask_model import synth_batch, tiny_cfg

from boxinstseg_tpu_torch.models.backbones.swin import SwinTransformer
from boxinstseg_tpu_torch.models.detectors.maskformer import \
    panoptic_postprocess
from boxinstseg_tpu_torch.ops import swin_attention as tsa
from boxinstseg_tpu_torch.registry import build_detector
from boxinstseg_tpu_torch.utils.weights import params_from_jax

ATOL, RTOL = 1e-5, 1e-4
GRAD_TOL = 3e-4

TINY_SWIN = dict(embed_dims=16, depths=(2, 2, 2, 1), num_heads=(2, 2, 4, 4),
                 window_size=4)


def swin_box2mask_cfg():
    """The tiny Box2Mask on a Swin of window 3: the 32, 16, 8 and 4 token
    maps of a 128x128 image all need padding, no window shrinks."""
    cfg = tiny_cfg()
    cfg['backbone'] = dict(type='SwinTransformer', embed_dims=16,
                           depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4),
                           window_size=3, out_indices=(0, 1, 2, 3))
    cfg['panoptic_head'] = dict(cfg['panoptic_head'],
                                in_channels=[16, 32, 64, 128])
    return cfg


@pytest.fixture
def interpret():
    swa._FORCE_INTERPRET = True
    yield
    swa._FORCE_INTERPRET = False


def _attention_inputs(seed, hp, wp, ws, shift, images, heads, d):
    rng = np.random.RandomState(seed)
    regions = swa.shift_regions(hp, wp, ws, shift)
    nw, _, n = regions.shape
    bw = images * nw
    arrays = [rng.randn(bw, n, heads * d).astype(np.float32)
              for _ in range(4)]                      # q, k, v, g
    bias = rng.randn(heads, n, n).astype(np.float32)
    return arrays, bias, regions


# (hp, wp, window, shift, images, heads, head dim); windows 14 and 16 at
# head dim 32 (N = 196, which the JAX package computes in XLA, and 256, in
# its kernel) are where K6 adds dS into its partial slice on the card
@pytest.mark.parametrize('case', [(8, 8, 4, 2, 2, 2, 8),     # shifted
                                  (8, 12, 4, 0, 2, 2, 8),    # regions 0
                                  (14, 14, 7, 3, 2, 3, 8),   # N = 49
                                  (28, 28, 14, 7, 1, 2, 32),  # N = 196
                                  (32, 32, 16, 8, 1, 2, 32)],  # N = 256
                         ids=['shifted', 'unshifted', 'window7', 'window14',
                              'window16'])
def test_window_attention_matches_interpret_kernel(interpret, case):
    (q, k, v, g), bias, regions = _attention_inputs(0, *case)
    assert (regions.max() > 0) == (case[3] > 0)
    scale = case[6] ** -0.5
    out_j, vjp = jax.vjp(lambda *a: swa.window_attention(
        *a, jnp.asarray(regions), scale), *map(jnp.asarray, (q, k, v, bias)))
    grads_j = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (q, k, v, bias)]
    out_t = tsa.window_attention(*leaves, torch.from_numpy(regions), scale)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=ATOL, rtol=RTOL)
    out_t.backward(torch.from_numpy(g))
    for name, t, want in zip('qkvb', leaves, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    # the explicit plain backward equals autograd through the plain forward
    t_args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    explicit = tsa.window_attention_backward_plain(
        *t_args, torch.from_numpy(regions), scale, torch.from_numpy(g))
    leaves = [a.clone().requires_grad_(True) for a in t_args]
    auto = torch.autograd.grad(tsa.window_attention_plain(
        *leaves, torch.from_numpy(regions), scale), leaves,
        torch.from_numpy(g))
    for name, got, want in zip('qkvb', explicit, auto):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL,
                                   msg=name)


def _scalar_weights(outs, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*o.shape).astype(np.float32) for o in outs]


@pytest.mark.parametrize('frozen_stages', [-1, 2])
def test_backbone_outputs_and_gradients_match_jax(frozen_stages):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 40, 56, 3).astype(np.float32)
    jm = JSwinTransformer(**TINY_SWIN, frozen_stages=frozen_stages)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    params = jax.tree_util.tree_map(np.asarray, params)
    # the 40x56 input gives 10x14, 5x7, 3x4 and 2x2 token maps: stages 2
    # and 3 shrink the window of 4 to 3 and 2, and their tables with it
    assert params['stage2_block1']['attn'][
        'relative_position_bias_table'].shape == (25, 4)
    # NHWC outputs of the 40x56 input: 10x14, 5x7, 3x4 and 2x2 maps
    weights = _scalar_weights([np.zeros((2, 10, 14, 16)),
                               np.zeros((2, 5, 7, 32)),
                               np.zeros((2, 3, 4, 64)),
                               np.zeros((2, 2, 2, 128))], 2)

    def scalar(p, xx):
        outs = jm.apply({'params': p}, xx)
        return sum((o * w).sum() for o, w in zip(outs, weights)), outs

    (_, outs_j), (g_params, g_x) = jax.jit(jax.value_and_grad(
        scalar, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tm = SwinTransformer(**TINY_SWIN, frozen_stages=frozen_stages)
    sd = params_from_jax({'backbone_m': params}, {})
    tm.load_state_dict({k[len('backbone.'):]: v for k, v in sd.items()},
                       strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous() \
        .requires_grad_(True)
    outs_t = tm(xt)
    assert len(outs_t) == len(outs_j) == 4
    for o_t, o_j in zip(outs_t, outs_j):
        np.testing.assert_allclose(o_t.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(o_j), atol=ATOL, rtol=RTOL)
    sum((o.permute(0, 2, 3, 1) * torch.from_numpy(w)).sum()
        for o, w in zip(outs_t, weights)).backward()
    if frozen_stages == 2:
        assert xt.grad is None and not np.asarray(g_x).any()
    else:
        _close_scaled(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g_x),
                      'input')
    want = params_from_jax({'backbone_m': jax.tree_util.tree_map(
        np.asarray, g_params)}, {})
    named = dict(tm.named_parameters())
    assert {f'backbone.{k}' for k in named} == {
        k for k in want if not k.endswith('relative_position_index')}
    # frozen: the patch embedding, stage 0 and 1's blocks and the merging
    # between them get no gradient (the JAX package's zeros); their output
    # norms do
    frozen = ('patch_embed.', 'stages.0.', 'stages.1.blocks.')
    for k, p in named.items():
        w = want[f'backbone.{k}'].numpy()
        if frozen_stages == 2 and k.startswith(frozen):
            assert p.grad is None and not w.any(), k
        else:
            _close_scaled(p.grad.numpy(), w, k)


def _close_scaled(got, want, what):
    ref = np.abs(want).max()
    assert ref > 0, what
    np.testing.assert_allclose(got, want, atol=ATOL * max(ref, 1.0),
                               rtol=RTOL, err_msg=what)


def make_batch(seed):
    return {k: np.asarray(v) for k, v in synth_batch(
        np.random.RandomState(seed)).items()}


def torch_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out['image'] = out['image'].permute(0, 3, 1, 2).contiguous()
    return out


@pytest.fixture(scope='module')
def swin_b2m():
    """The JAX model, its variables, and the port model with its weights."""
    jm = j_build(swin_box2mask_cfg())
    v = init_variables(jm, {'params': jax.random.PRNGKey(0)},
                       {k: jnp.asarray(x) for k, x in make_batch(0).items()},
                       jnp.zeros((), jnp.int32), method=jm.loss)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    tm = build_detector(swin_box2mask_cfg())
    tm.load_state_dict(params_from_jax(v['params'], v.get('batch_stats')),
                       strict=True)
    return jm, v, tm.train()


def test_params_from_jax_round_trips_through_converter(swin_b2m):
    _, v, tm = swin_b2m
    p, s = convert_reference_checkpoint(tm.state_dict())
    for want, got in ((v['params'], p), (v.get('batch_stats', {}), s)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            np.testing.assert_array_equal(np.asarray(flat_g[path]),
                                          np.asarray(leaf))


def test_loss_dict_and_backbone_grads_match_jax(swin_b2m):
    jm, v, tm = swin_b2m
    batch = make_batch(2)
    rest = {k: x for k, x in v.items() if k != 'params'}

    def total(params, b):
        losses = jm.apply({'params': params, **rest}, b,
                          jnp.zeros((), jnp.int32), method=jm.loss)
        return sum(x for k, x in losses.items() if 'loss' in k), losses

    (_, want), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        v['params'], {k: jnp.asarray(x) for k, x in batch.items()})
    tm.zero_grad()
    got = tm.loss(torch_batch(batch))
    assert set(got) == set(want)
    assert 'd0.loss_levelset' in got and 'd2.loss_cls' in got
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), rel=RTOL), k
    sum(x for k, x in got.items() if 'loss' in k).backward()
    want_g = params_from_jax({'backbone_m': jax.tree_util.tree_map(
        np.asarray, grads['backbone_m'])}, {})
    named = {k: p for k, p in tm.named_parameters()
             if k.startswith('backbone.')}
    assert set(named) == {k for k in want_g
                          if not k.endswith('relative_position_index')}
    for k, p in named.items():
        _close_scaled(p.grad.numpy(), want_g[k].numpy(), k)


def test_predict_matches_jax(swin_b2m):
    jm, v, tm = swin_b2m
    batch = make_batch(3)
    want = jax.jit(lambda vv, b: jm.apply(vv, b, method=jm.predict))(
        v, {'image': jnp.asarray(batch['image'])})
    tm.eval()
    try:
        got = tm.predict(torch_batch({'image': batch['image']}))
    finally:
        tm.train()
    assert set(got) == set(want)
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(want['labels']))
    np.testing.assert_allclose(got['masks_logit'].numpy(),
                               np.asarray(want['masks_logit']),
                               atol=ATOL * 10, rtol=RTOL)
    assert got['masks_logit'].shape == (2, 10, 32, 32)
    assert bool(got['valid'].all())


def test_panoptic_postprocess_matches_jax():
    rng = np.random.RandomState(3)
    q, things, stuff, h, w = 12, 5, 3, 20, 24
    mask_cls = rng.randn(q, things + stuff + 1).astype(np.float32)
    # peaked logits so that some queries pass object_mask_thr 0.8
    mask_cls[np.arange(0, q, 2), rng.randint(0, things + stuff, q // 2)] += 6
    mask_cls[5, -1] += 8                               # a background query
    # each query's mask covers its own cell of a 3x4 grid, and a little of
    # its neighbours'
    mask_pred = (rng.randn(q, h, w) - 4).astype(np.float32)
    for i in range(q):
        r, c = divmod(i, 4)
        mask_pred[i, r * 7:r * 7 + 8, c * 6:c * 6 + 7] += 8
    for low in (False, True):
        want = np.asarray(j_panoptic_postprocess(
            jnp.asarray(mask_cls), jnp.asarray(mask_pred), things, stuff,
            filter_low_score=low))
        got = panoptic_postprocess(torch.from_numpy(mask_cls),
                                   torch.from_numpy(mask_pred), things, stuff,
                                   filter_low_score=low)
        np.testing.assert_array_equal(got.numpy(), want)
        # thing instances, and void where no winner's own mask is >= 0.5
        assert (want >= 1000).any() and (want < things + stuff).any()
        assert (want == things + stuff).any() == low
