"""Port's BoxInst pairwise loss (plain version and CUDA kernel pair) against
the JAX package's ``boxinst_pairwise_loss`` and its Pallas kernels (run in
interpret mode on the CPU).

Tolerances (fp32): value rel 1e-5 and gradient atol 1e-5 / rtol 1e-4 against
JAX (summation order). Gradients are compared unnormalised, i.e. both sides
multiplied by max(den, 1), so that their entries are O(1) and the absolute
term holds at every shape. The kernels themselves are compared with the
plain version on a GPU in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.ops.pairwise import boxinst_pairwise_loss as jax_loss
from boxinstseg_tpu.ops.pallas_kernels import boxinst_pairwise_loss_pallas
from boxinstseg_tpu_torch.ops import pairwise as pw
from boxinstseg_tpu_torch.ops.color import neighbor_offsets

SHAPES = [(2, 8, 32, 48), (1, 3, 37, 53), (2, 4, 18, 22)]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    b, k, h, w = shape
    logits = (rng.randn(b, k, h, w) * 2).astype(np.float32)
    sim = rng.rand(b, 8, h, w).astype(np.float32)
    masks = (rng.rand(b, k, h, w) > 0.5).astype(np.float32)
    valid = rng.rand(b, k) > 0.2
    valid[0, -1] = False
    return logits, sim, masks, valid


def _port_value_grad(logits, sim, masks, valid):
    x = torch.tensor(logits, requires_grad=True)
    loss = pw.boxinst_pairwise_loss(x, torch.tensor(sim), torch.tensor(masks),
                                    torch.tensor(valid), 0.3, 3, 2)
    loss.backward()
    return loss.item(), x.grad.numpy()


def _den(sim, masks, valid):
    """max(den, 1): the loss's normaliser (an exact count of weights)."""
    _, den = pw.pairwise_num_den_plain(
        torch.zeros(masks.shape), torch.tensor(sim), torch.tensor(masks),
        torch.tensor(valid))
    return max(den.item(), 1.0)


@pytest.mark.parametrize('shape', SHAPES)
def test_plain_matches_jax_xla(shape):
    logits, sim, masks, valid = _inputs(shape, 0)
    args = tuple(jnp.asarray(a) for a in (sim, masks, valid))
    want, g_want = jax.value_and_grad(
        lambda x: jax_loss(x, *args, 0.3, 3, 2))(jnp.asarray(logits))
    got, g_got = _port_value_grad(logits, sim, masks, valid)
    assert got == pytest.approx(float(want), rel=1e-5)
    den = _den(sim, masks, valid)
    np.testing.assert_allclose(g_got * den, np.asarray(g_want) * den,
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize('shape', [(2, 8, 32, 48), (1, 3, 37, 53)])
def test_plain_matches_jax_pallas_interpret(shape):
    logits, sim, masks, valid = _inputs(shape, 1)
    args = tuple(jnp.asarray(a) for a in (sim, masks, valid))
    want, g_want = jax.value_and_grad(
        lambda x: boxinst_pairwise_loss_pallas(x, *args, 0.3, 3, 2, True))(
        jnp.asarray(logits))
    got, g_got = _port_value_grad(logits, sim, masks, valid)
    assert got == pytest.approx(float(want), rel=1e-5)
    den = _den(sim, masks, valid)
    np.testing.assert_allclose(g_got * den, np.asarray(g_want) * den,
                               atol=1e-5, rtol=1e-4)


def test_analytic_backward_matches_autograd():
    logits, sim, masks, valid = _inputs((2, 4, 18, 22), 2)
    t = [torch.tensor(a) for a in (sim, masks, valid)]
    x = torch.tensor(logits, requires_grad=True)
    num, den = pw.pairwise_num_den_plain(x, *t)
    (num / den.clamp(min=1.0)).backward()
    _, g = _port_value_grad(logits, sim, masks, valid)
    np.testing.assert_allclose(g, x.grad.numpy(), atol=1e-7, rtol=1e-5)


def test_kernel_gather_formula_matches_plain():
    """K2 computes the gradient as a gather over the opposite offsets:
    (w_d(p) + w_opp(d)(p + o_d)) * (s(p) - pA_d(p)). Checked here in
    torch, since the kernel itself runs only on the card."""
    logits, sim, masks, valid = [torch.tensor(a) for a in
                                 _inputs((2, 5, 21, 30), 3)]
    h, w = logits.shape[-2:]
    r = 2
    pad = lambda t: F.pad(t, (r, r, r, r))  # noqa: E731
    lf, lb = F.logsigmoid(logits), F.logsigmoid(-logits)
    s = torch.sigmoid(logits)
    wb = masks * valid.float()[..., None, None]
    lfp, lbp, wbp, simp = pad(lf), pad(lb), pad(wb), pad(sim)
    offs = neighbor_offsets(3, 2)
    acc = torch.zeros_like(logits)
    for d, (dy, dx) in enumerate(offs):
        at = lambda t: t[..., r + dy:r + dy + h, r + dx:r + dx + w]  # noqa
        w_c = wb * (sim[:, d] >= 0.3).float()[:, None]
        w_n = at(wbp) * (at(simp[:, len(offs) - 1 - d]) >= 0.3).float()[
            :, None]
        a = lf + at(lfp)
        m = torch.logaddexp(a, lb + at(lbp))
        acc = acc + (w_c + w_n) * (s - torch.exp(a - m))
    want = pw.pairwise_grad_plain(logits, sim, masks, valid)
    np.testing.assert_allclose(acc.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-5)


def test_cpu_tensor_takes_plain_path():
    logits, sim, masks, valid = _inputs((1, 3, 37, 53), 4)
    fwd, bwd = pw.pairwise_forward_cuda.launches, pw.pairwise_grad_cuda.launches
    _port_value_grad(logits, sim, masks, valid)
    assert (pw.pairwise_forward_cuda.launches,
            pw.pairwise_grad_cuda.launches) == (fwd, bwd)


def test_kernel_wrappers_reject_cpu_tensors():
    t = [torch.tensor(a) for a in _inputs((1, 3, 8, 8), 5)]
    with pytest.raises(ValueError, match='CUDA'):
        pw.pairwise_forward_cuda(*t)
    with pytest.raises(ValueError, match='CUDA'):
        pw.pairwise_grad_cuda(*t, torch.ones(1))


@pytest.mark.parametrize('shape,kernel_size,dilation',
                         [((2, 6, 37, 53), 3, 2), ((2, 6, 21, 30), 3, 1),
                          ((1, 6, 37, 53), 5, 1)])
def test_kernel_pair_arithmetic_matches_jax_on_boxes(shape, kernel_size,
                                                     dilation):
    """The redesigned kernels' arithmetic (one evaluation an unordered pair
    with den counted apart; forward pair probabilities gathered G a
    pixel), written out in ``test_torch_pairwise_plan``, against JAX's
    ``boxinst_pairwise_loss`` and its analytic backward, on box bitmasks
    (inside one tile, a frame on every border, empty, invalid, the whole
    plane, across tiles)."""
    from test_torch_pairwise_plan import (box_inputs, gate_sim,
                                          pair_grad, pair_num_den)
    logits, sim8, masks, valid = box_inputs(shape, 6)
    sim = gate_sim(sim8, kernel_size).numpy()
    args = tuple(jnp.asarray(a) for a in (sim, masks, valid))
    want, g_want = jax.value_and_grad(lambda x: jax_loss(
        x, *args, 0.3, kernel_size, dilation))(jnp.asarray(logits))
    t = [torch.tensor(a) for a in (logits, sim, masks, valid)]
    num, den = pair_num_den(*t, 0.3, kernel_size, dilation)
    scale = max(den.item(), 1.0)
    assert num.item() / scale == pytest.approx(float(want), rel=1e-5)
    grad = pair_grad(*t, 0.3, kernel_size, dilation)
    np.testing.assert_allclose(grad.numpy(), np.asarray(g_want) * scale,
                               atol=1e-5, rtol=1e-4)
