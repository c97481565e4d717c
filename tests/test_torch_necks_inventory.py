"""The port's FPN (every ``add_extra_convs``), PAFPN, ChannelMapper and
FPN_CARAFE against the JAX package, on the CPU, in fp32.

Each neck is built from the same config in both packages with narrow
channels, the JAX variables perturbed from their init and converted with
``params_from_jax`` (the CARAFE content encoder's channels permuted from
the JAX layout to mmcv's), loaded with ``strict=True``. The outputs and
the inputs' gradients (of a fixed projection of the outputs) agree within
atol 1e-5 / rtol 1e-4, on maps of odd sizes where the neck allows them
(FPN_CARAFE crops its 2x upsample to the odd lateral below).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boxinstseg_tpu.ops.carafe import carafe_reassemble as j_reassemble
from boxinstseg_tpu.registry import NECKS as J_NECKS

from boxinstseg_tpu_torch.ops.carafe import carafe_reassemble
from boxinstseg_tpu_torch.registry import NECKS
from boxinstseg_tpu_torch.utils.weights import params_from_jax
from test_torch_backbones_inventory import nchw, perturb, projection, strip

ATOL, RTOL = 1e-5, 1e-4
CHANNELS = (8, 16, 32, 64)
SIZES = ((32, 24), (16, 12), (8, 6), (4, 3))
ODD_SIZES = ((15, 13), (8, 7), (4, 4), (2, 2))
EXTRA = (False, True, 'on_input', 'on_lateral', 'on_output')

CASES = {
    **{f'FPN-{mode}': (dict(type='FPN', in_channels=CHANNELS,
                            out_channels=16, start_level=1, num_outs=5,
                            add_extra_convs=mode,
                            relu_before_extra_convs=True), SIZES)
       for mode in EXTRA},
    **{f'PAFPN-{mode}': (dict(type='PAFPN', in_channels=CHANNELS,
                              out_channels=16, start_level=1, num_outs=5,
                              add_extra_convs=mode,
                              relu_before_extra_convs=True), SIZES)
       for mode in EXTRA},
    'PAFPN-start0': (dict(type='PAFPN', in_channels=CHANNELS,
                          out_channels=16, num_outs=5), SIZES),
    'ChannelMapper-GN': (dict(type='ChannelMapper', in_channels=CHANNELS,
                              out_channels=16, kernel_size=3,
                              norm_cfg=dict(type='GN', num_groups=4),
                              act_cfg=dict(type='ReLU'), num_outs=6),
                         ODD_SIZES),
    'ChannelMapper-BN': (dict(type='ChannelMapper', in_channels=CHANNELS,
                              out_channels=16, kernel_size=1,
                              norm_cfg=dict(type='BN')), ODD_SIZES),
    'FPN_CARAFE': (dict(type='FPN_CARAFE', in_channels=CHANNELS,
                        out_channels=16, num_outs=5), ODD_SIZES),
    'FPN_CARAFE-start1': (dict(type='FPN_CARAFE', in_channels=CHANNELS,
                               out_channels=16, start_level=1, num_outs=5,
                               upsample_cfg=dict(type='carafe', up_kernel=3,
                                                 up_group=1,
                                                 encoder_kernel=5,
                                                 encoder_dilation=2)),
                          ODD_SIZES),
}


def neck_pair(name, seed=0):
    cfg, sizes = CASES[name]
    rng = np.random.RandomState(seed)
    xs = [rng.randn(2, h, w, c).astype(np.float32)
          for c, (h, w) in zip(CHANNELS, sizes)]
    jm = J_NECKS.build(dict(cfg))
    jxs = [jnp.asarray(x) for x in xs]
    v = jax.tree_util.tree_map(np.asarray, dict(
        jax.jit(jm.init)(jax.random.PRNGKey(0), jxs)))
    v = perturb(v, rng)

    def loss(inputs):
        ys, _ = jm.apply(v, inputs, train=True, mutable=['batch_stats'])
        ys = [y.transpose(0, 3, 1, 2) for y in ys]
        return sum((y * projection(y.shape)).sum() for y in ys), ys
    (_, outs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jxs)

    tm = NECKS.build(dict(cfg)).train()
    tm.load_state_dict(strip(params_from_jax(
        {'neck_m': v['params']}, {'neck_m': v.get('batch_stats', {})}),
        'neck.'), strict=True)
    txs = [nchw(x).requires_grad_() for x in xs]
    touts = tm(txs)
    sum((y * torch.from_numpy(projection(y.shape))).sum()
        for y in touts).backward()
    return outs, touts, grads, txs


@pytest.mark.parametrize('name', list(CASES))
def test_neck_matches_jax(name):
    outs, touts, grads, txs = neck_pair(name)
    assert len(outs) == len(touts)
    for a, b in zip(outs, touts):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=ATOL, rtol=RTOL)
    for g, x in zip(grads, txs):
        got = np.zeros(g.shape, np.float32) if x.grad is None \
            else x.grad.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, np.asarray(g), atol=ATOL, rtol=RTOL)


def test_fpn_extra_conv_sources():
    """'on_input' reads the last used input, so its first extra conv takes
    that input's channels; the other modes read out_channels maps."""
    for mode, cin in (('on_input', 64), ('on_lateral', 16),
                      ('on_output', 16)):
        for typ in ('FPN', 'PAFPN'):
            m = NECKS.build(dict(CASES[f'{typ}-{mode}'][0]))
            assert m.fpn_convs[3].conv.weight.shape == (16, cin, 3, 3)
            assert m.fpn_convs[4].conv.weight.shape == (16, 16, 3, 3)
    with pytest.raises(ValueError):
        NECKS.build(dict(type='FPN', add_extra_convs='on_everything'))


@pytest.mark.parametrize('k_up', [3, 5])
def test_carafe_reassemble_matches_jax(k_up):
    rng = np.random.RandomState(k_up)
    x = rng.randn(2, 7, 5, 6).astype(np.float32)
    kern = rng.rand(2, 14, 10, k_up * k_up).astype(np.float32)
    want = np.asarray(j_reassemble(jnp.asarray(x), jnp.asarray(kern), 2,
                                   k_up))
    got = carafe_reassemble(nchw(x), nchw(kern), 2, k_up)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL, rtol=RTOL)


def test_tiny_boxinst_with_resnest_and_pafpn_matches_jax():
    """The tiny BoxInst of tests/test_torch_slice.py on a three-stage
    ResNeSt-50 and a PAFPN (P3-P4 and three extra convs on the output):
    the loss dict at rtol 1e-4, from one JAX init with perturbed frozen-BN
    statistics."""
    from boxinstseg_tpu.engine import init_variables
    from boxinstseg_tpu.registry import build_detector as j_build
    from boxinstseg_tpu_torch.registry import build_detector
    from test_torch_slice import make_batch, tiny_cfg, torch_batch
    cfg = tiny_cfg(pairwise_warmup=1)
    cfg['backbone'] = dict(type='ResNeSt', depth=50, num_stages=3,
                           out_indices=(0, 1, 2), frozen_stages=1)
    cfg['neck'] = dict(type='PAFPN', in_channels=[256, 512, 1024],
                       out_channels=32, start_level=1,
                       add_extra_convs='on_output', num_outs=5,
                       relu_before_extra_convs=True)
    jm = j_build(cfg)
    batch = make_batch(0)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    v = jax.tree_util.tree_map(np.asarray, dict(init_variables(
        jm, {'params': jax.random.PRNGKey(0)}, jb,
        jnp.zeros((), jnp.int32), method=jm.loss)))
    v['batch_stats'] = perturb(v['batch_stats'], np.random.RandomState(1))
    want, _ = jax.jit(lambda v, b: jm.apply(
        v, b, jnp.asarray(50, jnp.int32), method=jm.loss,
        mutable=['batch_stats']))(v, jb)
    tm = build_detector(cfg)
    tm.load_state_dict(params_from_jax(v['params'], v['batch_stats']),
                       strict=True)
    with torch.no_grad():
        got = tm.train().loss(torch_batch(batch), 50)
    assert set(got) == set(want)
    assert float(want['loss_pairwise']) > 0
    for k in want:
        assert got[k].item() == pytest.approx(float(want[k]), rel=RTOL,
                                              abs=1e-6), k
