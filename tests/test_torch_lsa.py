"""The port's linear sum assignment (``ops/lsa.py``, plain version) and
its Hungarian match against the JAX package's ``solve_lsa`` and
``hungarian_match``, on the CPU.

The port runs the JAX algorithm step for step in fp32, so the assignments
must be equal element for element, tied costs included (D2 was the port's
host scipy solve, which breaks exact ties another way); the total cost
must equal scipy's optimum within rel 1e-6. The kernel's own test against
this plain version is ``tests/test_torch_cuda.py`` (``cuda``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from scipy.optimize import linear_sum_assignment

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.core.targets.hungarian import \
    hungarian_match as j_hungarian_match
from boxinstseg_tpu.ops.lsa import solve_lsa as j_solve_lsa

from boxinstseg_tpu_torch.core.targets.hungarian import hungarian_match
from boxinstseg_tpu_torch.ops.lsa import solve_lsa, solve_lsa_plain


def _cases():
    rng = np.random.RandomState(0)
    rand = (rng.randn(6, 12, 17) * rng.choice([0.1, 1, 100])
            ).astype(np.float32)
    tied = rng.randint(0, 3, (6, 20, 24)).astype(np.float32)
    padded = rng.randn(6, 10, 14).astype(np.float32)
    crowded = (rng.randn(2, 100, 100) * 3).astype(np.float32)
    return {
        'random': (rand, np.full(6, 12)),
        'tied': (tied, np.array([20, 20, 13, 7, 1, 20])),
        'padded': (padded, np.array([0, 3, 10, 1, 7, 9])),
        'crowded': (crowded, np.array([100, 93])),
        'square-tied': (np.ones((3, 9, 9), np.float32), np.full(3, 9)),
    }


CASES = _cases()


def jax_lsa(cost, n_rows):
    return np.asarray(jax.jit(jax.vmap(j_solve_lsa))(
        jnp.asarray(cost), jnp.asarray(n_rows.astype(np.int32))))


@pytest.mark.parametrize('name', sorted(CASES))
def test_plain_lsa_equals_jax_and_scipys_optimum(name):
    cost, n_rows = CASES[name]
    want = jax_lsa(cost, n_rows)
    got = solve_lsa(torch.from_numpy(cost),
                    torch.from_numpy(n_rows.astype(np.int32)))
    assert got.dtype == torch.int64
    got = got.numpy()
    for p, k in enumerate(n_rows):
        np.testing.assert_array_equal(got[p, :k], want[p, :k])
        assert (got[p, k:] == 0).all()
        assert len(set(got[p, :k].tolist())) == k
        r, c = linear_sum_assignment(cost[p, :k])
        opt = cost[p, :k][r, c].astype(np.float64).sum()
        total = cost[p, np.arange(k), got[p, :k]].astype(np.float64).sum()
        assert abs(total - opt) <= 1e-6 * max(abs(opt), 1.0)


def test_single_problem_and_default_rows():
    cost, _ = CASES['random']
    got = solve_lsa(torch.from_numpy(cost[0]))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_solve_lsa(cost[0])))


def test_steps_count_the_searches():
    cost, n_rows = CASES['padded']
    _, steps = solve_lsa_plain(torch.from_numpy(cost),
                               torch.from_numpy(n_rows), return_steps=True)
    # each live row takes one step at least, a problem without rows none
    assert steps[0] == 0
    assert (steps >= torch.from_numpy(n_rows)).all()


def test_n_greater_than_m_raises():
    with pytest.raises(AssertionError):
        solve_lsa(torch.zeros(1, 5, 4))


def _match_inputs(seed, b=3, q=10, g=6, tied=False):
    rng = np.random.RandomState(seed)
    cost = (rng.randint(0, 2, (b, q, g)) if tied
            else rng.randn(b, q, g)).astype(np.float32)
    valid = rng.rand(b, g) > 0.4
    valid[0] = False
    valid[1, :] = True
    return cost, valid


@pytest.mark.parametrize('tied', [False, True])
def test_hungarian_match_equals_jax(tied, monkeypatch):
    """The port's match sorts, zeroes, solves and unsorts as the JAX one:
    the same queries, tied costs included (the D2 pin), with no call to
    scipy."""
    import scipy.optimize

    def no_scipy(*args, **kwargs):
        raise AssertionError('hungarian_match called scipy')
    monkeypatch.setattr(scipy.optimize, 'linear_sum_assignment', no_scipy)
    cost, valid = _match_inputs(1, tied=tied)
    want, want_valid = jax.jit(j_hungarian_match)(jnp.asarray(cost),
                                                  jnp.asarray(valid))
    got, got_valid = hungarian_match(torch.from_numpy(cost),
                                     torch.from_numpy(valid))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert (got.numpy()[~valid] == 0).all()


def test_box2mask_tied_costs_match_jax():
    """D2: a Box2Mask-shaped step (L x B problems, 100 queries, 20 GT
    slots) whose classification costs tie exactly (uniform logits) and
    whose dice costs tie between duplicated queries: the port's match
    equals JAX's query for query."""
    rng = np.random.RandomState(2)
    layers, b, q, g = 3, 2, 100, 20
    dice = rng.rand(layers, b, q // 4, g).astype(np.float32)
    cost = np.repeat(dice, 4, axis=2) - 1.0 / 81   # four equal queries
    valid = np.zeros((b, g), bool)
    valid[0, [1, 4, 5, 11]] = True
    valid[1, :13] = True
    flat = cost.reshape(layers * b, q, g)
    vflat = np.tile(valid, (layers, 1))
    want, _ = jax.jit(j_hungarian_match)(jnp.asarray(flat),
                                         jnp.asarray(vflat))
    got, _ = hungarian_match(torch.from_numpy(flat), torch.from_numpy(vflat))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
