"""The port's grid MST and tree filter against the JAX package, on the CPU.

- ``grid_mst`` (the op's CPU kernel, ``grid_mst_plain``): parent and depth
  EXACTLY equal to ``grid_mst_device``, on guides with many tied weights
  (flat colour blocks, where the tree depends on the (weight, edge index)
  tie order) and on guides with distinct weights, with ``max_depth``
  uncapped and binding; at the heads' 96 x 96 on four flat-block trees;
  on negative weights with ties between -0.0 and 0.0;
- the plain version against scipy's MST (``mst_witness.py``) at 96 x 96;
  the module imports no scipy;
- ``grid_mst_pair`` on two guides at once;
- ``tree_filter2d``: output and gradients (feature and guide) in both
  ``low_tree`` modes, uncapped and with a binding depth cap.

Tolerance of the filter: atol 1e-5 / rtol 1e-4 (fp32, summation order).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.ops.mst import grid_mst_device
from boxinstseg_tpu.ops.tree_filter import (grid_mst_pair as j_pair,
                                            tree_filter2d as j_filter)

from boxinstseg_tpu_torch.ops import mst
from boxinstseg_tpu_torch.ops.mst import grid_mst, grid_mst_plain
from mst_witness import host_grid_mst
from boxinstseg_tpu_torch.ops.tree_filter import grid_mst_pair, tree_filter2d


def _guide(kind, rng, b, h, w, d=3):
    if kind == 'blocks':
        # flat 3x3 colour blocks from 3 levels: most edge weights are 0
        # or repeat exactly
        blocks = rng.randint(0, 3, (b, h // 3 + 1, w // 3 + 1, d))
        g = np.repeat(np.repeat(blocks, 3, 1), 3, 2)[:, :h, :w]
        return g.astype(np.float32) * 0.5
    return rng.rand(b, h, w, d).astype(np.float32)


def _weights(g):
    return (((g[:, :, 1:] - g[:, :, :-1]) ** 2).sum(-1),
            ((g[:, 1:] - g[:, :-1]) ** 2).sum(-1))


@pytest.mark.parametrize('kind', ['blocks', 'distinct'])
@pytest.mark.parametrize('max_depth', [0, 12])
@pytest.mark.parametrize('hw', [(9, 11), (16, 16)])
def test_grid_mst_matches_jax_exactly(kind, max_depth, hw):
    rng = np.random.RandomState(hw[0] + max_depth)
    h, w = hw
    wr, wd = _weights(_guide(kind, rng, 3, h, w))
    if kind == 'blocks':
        assert (wr == 0).mean() > 0.3
    md = max_depth or h * w
    want_p, want_d = grid_mst_device(jnp.asarray(wr), jnp.asarray(wd), md)
    got_p, got_d = grid_mst(torch.from_numpy(wr), torch.from_numpy(wd), md)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    if max_depth:
        assert np.asarray(want_d).max() <= max_depth
        assert (np.asarray(want_p) == np.arange(h * w)).sum() > 3  # detached


def _assert_tree_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_grid_mst_matches_jax_at_96x96_on_flat_blocks():
    # the heads' tf_size (96, 96), uncapped, four trees of ~270-470 levels
    rng = np.random.RandomState(0)
    wr, wd = _weights(_guide('blocks', rng, 4, 96, 96))
    assert (wr == 0).mean() > 0.3
    want = grid_mst_device(jnp.asarray(wr), jnp.asarray(wd), 96 * 96)
    got = grid_mst(torch.from_numpy(wr), torch.from_numpy(wd), 96 * 96)
    _assert_tree_equal(got, want)
    assert got[1].max() > 200


@pytest.mark.parametrize('max_depth', [0, 4])
def test_grid_mst_matches_jax_on_negative_weights_and_signed_zeros(
        max_depth):
    # the op takes any fp32: negative weights order below 0, and -0.0
    # ties with 0.0 (broken by edge index, as the stable argsort does)
    rng = np.random.RandomState(11 + max_depth)
    h, w = 7, 9
    wr = np.round(rng.randn(2, h, w - 1) * 1.5).astype(np.float32)
    wd = np.round(rng.randn(2, h - 1, w) * 1.5).astype(np.float32)
    signs = rng.rand(*wr.shape) < 0.5
    wr[(wr == 0) & signs] = -0.0
    wd[(wd == 0) & (rng.rand(*wd.shape) < 0.5)] = -0.0
    assert np.signbit(wr[wr == 0]).any() and (~np.signbit(wr[wr == 0])).any()
    assert (wr < 0).any() and (wd < 0).any()
    md = max_depth or h * w
    want = grid_mst_device(jnp.asarray(wr), jnp.asarray(wd), md)
    got = grid_mst(torch.from_numpy(wr), torch.from_numpy(wd), md)
    _assert_tree_equal(got, want)


@pytest.mark.parametrize('kind', ['blocks', 'distinct'])
def test_grid_mst_plain_matches_scipy_at_96x96(kind):
    rng = np.random.RandomState(5)
    wr, wd = (torch.from_numpy(a) for a in _weights(
        _guide(kind, rng, 2, 96, 96)))
    for md in (96 * 96, 100):
        got = grid_mst_plain(wr, wd, md)
        want = host_grid_mst(wr, wd, md)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_mst_module_imports_no_scipy():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(mst))
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module or '' for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)]
    assert names and not any(n.split('.')[0] == 'scipy' for n in names)


def test_grid_mst_pair_matches_jax():
    rng = np.random.RandomState(7)
    a = _guide('blocks', rng, 2, 12, 10)
    b = rng.rand(2, 12, 10, 1).astype(np.float32)
    want = j_pair(jnp.asarray(a), jnp.asarray(b), 20)
    got = grid_mst_pair(torch.from_numpy(a), torch.from_numpy(b), 20)
    for (gp, gd), (wp, wd) in zip(got, want):
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize('low_tree', [True, False])
@pytest.mark.parametrize('max_depth', [0, 10])
def test_tree_filter_value_and_grads_match_jax(low_tree, max_depth):
    rng = np.random.RandomState(3 + max_depth)
    b, h, w, c = 2, 10, 12, 5
    guide = rng.rand(b, h, w, 2).astype(np.float32) * (
        0.3 if low_tree else 1.0)
    feat = rng.rand(b, h, w, c).astype(np.float32)
    gout = rng.randn(b, h, w, c).astype(np.float32)
    md = max_depth or h * w
    parent, depth = grid_mst_device(*map(jnp.asarray, _weights(guide)), md)

    def jfn(f, g):
        return (j_filter(f, g, parent, depth, sigma=0.02,
                         low_tree=low_tree, max_depth=md) * gout).sum()

    want_out = j_filter(jnp.asarray(feat), jnp.asarray(guide), parent,
                        depth, sigma=0.02, low_tree=low_tree, max_depth=md)
    want_df, want_dg = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(feat),
                                                      jnp.asarray(guide))
    tf = torch.from_numpy(feat).requires_grad_(True)
    tg = torch.from_numpy(guide).requires_grad_(True)
    tp = torch.from_numpy(np.asarray(parent).astype(np.int64))
    td = torch.from_numpy(np.asarray(depth).astype(np.int64))
    got = tree_filter2d(tf, tg, tp, td, sigma=0.02, low_tree=low_tree,
                        max_depth=md)
    (got * torch.from_numpy(gout)).sum().backward()
    for g, want in ((got, want_out), (tf.grad, want_df),
                    (tg.grad, want_dg)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-4)
    assert np.abs(np.asarray(want_dg)).max() > 1e-3
