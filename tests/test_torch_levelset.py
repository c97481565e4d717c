"""The port's level-set losses and LCM refinement against the JAX package,
on the CPU.

- the refinement and its gradient against ``LocalConsistencyModule`` (its
  XLA scan on the CPU), and against the TPU kernel
  ``lcm_refine_pallas(..., interpret=True)`` in both directions;
- the gather form of the adjoint that ``csrc/lcm.cu`` computes, written
  out here, against the plain scatter adjoint, on planes whose edge rows
  and columns receive the clamped runs;
- ``region_levelset``, ``region_levelset_shared``,
  ``length_regularization``.

Tolerance: atol 1e-5 / rtol 1e-4 (fp32, summation order).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.models.losses import levelset_loss as jls
from boxinstseg_tpu.ops.pallas_kernels import lcm_refine_pallas

from boxinstseg_tpu_torch.models.losses import levelset_loss as tls
from boxinstseg_tpu_torch.ops import lcm

ATOL, RTOL = 1e-5, 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=rtol)


def _planes(seed, b, c, h, w):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 3, h, w).astype(np.float32),
            rng.rand(b, c, h, w).astype(np.float32),
            rng.randn(b, c, h, w).astype(np.float32))


@pytest.mark.parametrize('shape', [(2, 5, 12, 17), (1, 3, 3, 5),
                                   (2, 4, 24, 24)])
def test_lcm_refine_and_grad_match_jax(shape):
    imgs, phis, g = _planes(0, *shape)
    jm = jls.LocalConsistencyModule(dilations=(2,), num_iter=10)
    want, vjp = jax.vjp(lambda p: jm(jnp.asarray(imgs), p),
                        jnp.asarray(phis))
    want_g, = vjp(jnp.asarray(g))
    tm = tls.LocalConsistencyModule(dilations=(2,), num_iter=10)
    _close(tm.affinity(torch.from_numpy(imgs)),
           jm._affinity(jnp.asarray(imgs))[:, 0])
    p = torch.from_numpy(phis).requires_grad_(True)
    got = tm(torch.from_numpy(imgs), p)
    got.backward(torch.from_numpy(g))
    _close(got, want)
    _close(p.grad, want_g)


def test_lcm_plain_pair_matches_pallas_interpret():
    imgs, phis, g = _planes(1, 2, 3, 11, 13)
    jm = jls.LocalConsistencyModule(dilations=(2,), num_iter=4)
    aff = jm._affinity(jnp.asarray(imgs))[:, 0]
    offs = jm._offsets()
    want_f = lcm_refine_pallas(aff, jnp.asarray(phis), offs, 4, c_tile=2,
                               interpret=True)
    want_t = lcm_refine_pallas(aff, jnp.asarray(g), offs, 4, c_tile=2,
                               transpose=True, interpret=True)
    taff = torch.from_numpy(np.array(aff))
    _close(lcm.lcm_forward_plain(taff, torch.from_numpy(phis), offs, 4),
           want_f)
    _close(lcm.lcm_adjoint_plain(taff, torch.from_numpy(g), offs, 4),
           want_t)


def _source_run(q, d, n):
    """Python copy of csrc/lcm.cu source_run."""
    if d == 0:
        return q, q
    if d > 0:
        if q == n - 1:
            return max(n - 1 - d, 0), n - 1
        return (0, -1) if q < d else (q - d, q - d)
    if q == 0:
        return 0, min(-d, n - 1)
    return (0, -1) if q - d > n - 1 else (q - d, q - d)


def _adjoint_round_gather(aff, g, offsets):
    """One adjoint round as the CUDA kernel gathers it."""
    b, c, h, w = g.shape
    out = np.zeros_like(g)
    for y in range(h):
        for x in range(w):
            s = np.zeros((b, c), np.float64)
            for k, (dy, dx) in enumerate(offsets):
                ylo, yhi = _source_run(y, dy, h)
                xlo, xhi = _source_run(x, dx, w)
                for py in range(ylo, yhi + 1):
                    for px in range(xlo, xhi + 1):
                        s += aff[:, k, py, px][:, None] * g[:, :, py, px]
            out[:, :, y, x] = s
    return out


@pytest.mark.parametrize('hw', [(7, 9), (2, 3), (1, 5), (5, 1)])
@pytest.mark.parametrize('dilation', [1, 2, 3])
def test_kernel_adjoint_gather_matches_plain(hw, dilation):
    rng = np.random.RandomState(dilation)
    offs = tls.LocalConsistencyModule(dilations=(dilation,)).offsets()
    aff = rng.rand(2, len(offs), *hw).astype(np.float32)
    g = rng.randn(2, 3, *hw).astype(np.float32)
    want = lcm.apply_at(torch.from_numpy(aff), torch.from_numpy(g), offs)
    got = _adjoint_round_gather(aff, g, offs)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=1e-5)


def test_lcm_adjoint_identity():
    """<A x, y> = <x, A^T y> for the plain pair."""
    imgs, x, y = _planes(3, 1, 3, 9, 14)
    tm = tls.LocalConsistencyModule(dilations=(2,), num_iter=10)
    aff = tm.affinity(torch.from_numpy(imgs))
    ax = lcm.lcm_forward_plain(aff, torch.from_numpy(x), tm.offsets(), 10)
    aty = lcm.lcm_adjoint_plain(aff, torch.from_numpy(y), tm.offsets(), 10)
    lhs = float((ax.double() * torch.from_numpy(y).double()).sum())
    rhs = float((torch.from_numpy(x).double() * aty.double()).sum())
    assert lhs == pytest.approx(rhs, rel=1e-5)


def test_region_levelset_and_length_match_jax():
    rng = np.random.RandomState(4)
    score = rng.rand(6, 2, 10, 12).astype(np.float32)
    target = rng.randn(6, 3, 10, 12).astype(np.float32)
    _close(tls.region_levelset(torch.from_numpy(score),
                               torch.from_numpy(target)),
           jls.region_levelset(jnp.asarray(score), jnp.asarray(target)))
    _close(tls.length_regularization(torch.from_numpy(score)),
           jls.length_regularization(jnp.asarray(score)))
    fg = rng.rand(2, 4, 10, 12).astype(np.float32)
    box = (rng.rand(2, 4, 10, 12) > 0.4).astype(np.float32)
    img = rng.randn(2, 3, 10, 12).astype(np.float32)
    want = jls.region_levelset_shared(*map(jnp.asarray, (fg, box, img)))
    got = tls.region_levelset_shared(*map(torch.from_numpy, (fg, box, img)))
    _close(got, want)
    # and the shared form is the stacked region energy
    stacked = tls.region_levelset(
        torch.from_numpy(np.stack([fg, 1 - fg], 2) * box[:, :, None]
                         ).reshape(8, 2, 10, 12),
        torch.from_numpy(img[:, None] * box[:, :, None]).reshape(
            8, 3, 10, 12))
    _close(got.reshape(-1), stacked)
