"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a GPU. Every test here is marked ``cuda`` and skips without a
CUDA device. This file imports no JAX, so it also runs where only PyTorch
is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances (fp32, summation order): value rtol 1e-5; gradient atol 1e-6 /
rtol 1e-5 on the unnormalised gradient d(num)/d(logits), whose entries are
O(1). Through autograd the gradient is divided by max(den, 1), so there the
absolute term is divided by it too.
"""
import numpy as np
import pytest
import torch

from boxinstseg_tpu_torch.ops import pairwise as pw

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _inputs(shape, seed, device):
    rng = np.random.RandomState(seed)
    b, k, h, w = shape
    arrays = ((rng.randn(b, k, h, w) * 2).astype(np.float32),
              rng.rand(b, 8, h, w).astype(np.float32),
              (rng.rand(b, k, h, w) > 0.5).astype(np.float32),
              rng.rand(b, k) > 0.2)
    out = [torch.from_numpy(a).to(device) for a in arrays]
    out[3][0, -1] = False
    return out


# the main path's shape (batch 2, topk_per_img 64, 800x1344 / 4) and ragged
# ones that are not a multiple of the 32x8 tile, with one and two images
@pytest.mark.parametrize('shape', [(2, 64, 200, 336), (1, 3, 37, 53),
                                   (2, 5, 37, 53)])
def test_pairwise_kernels_match_plain(cuda, shape):
    logits, sim, masks, valid = _inputs(shape, 0, cuda)
    xk = logits.clone().requires_grad_(True)
    vk = pw.PairwiseLossFunction.apply(xk, sim, masks, valid, 0.3, 3, 2)
    vk.backward()
    xp = logits.clone().requires_grad_(True)
    vp = pw.PlainPairwiseLossFunction.apply(xp, sim, masks, valid, 0.3, 3,
                                            2)
    vp.backward()
    one = torch.ones(1, device=cuda)
    g_kernel = pw.pairwise_grad_cuda(logits, sim, masks, valid, one)
    g_plain = pw.pairwise_grad_plain(logits, sim, masks, valid)
    _, den = pw.pairwise_num_den_plain(logits, sim, masks, valid)
    torch.cuda.synchronize()
    assert vk.item() == pytest.approx(vp.item(), rel=1e-5)
    assert g_plain.abs().max().item() > 0.1
    torch.testing.assert_close(g_kernel, g_plain, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(xk.grad, xp.grad,
                               atol=1e-6 / max(den.item(), 1.0), rtol=1e-5)


@pytest.mark.parametrize('shape', [(1, 2, 45, 70), (2, 3, 45, 70)])
def test_largest_halo_matches_plain(cuda, shape):
    # dilation 16 at kernel size 3: the largest halo the tiles take
    logits, sim, masks, valid = _inputs(shape, 3, cuda)
    num, den = pw.pairwise_forward_cuda(logits, sim, masks, valid, 0.3, 3, 16)
    want_num, want_den = pw.pairwise_num_den_plain(logits, sim, masks, valid,
                                                   0.3, 3, 16)
    assert num.item() == pytest.approx(want_num.item(), rel=1e-5)
    assert den.item() == want_den.item()
    scale = torch.ones(1, device=cuda)
    torch.testing.assert_close(
        pw.pairwise_grad_cuda(logits, sim, masks, valid, scale, 0.3, 3, 16),
        pw.pairwise_grad_plain(logits, sim, masks, valid, 0.3, 3, 16),
        atol=1e-5, rtol=1e-5)


def test_dispatch_launches_kernels_for_cuda_tensors(cuda):
    logits, sim, masks, valid = _inputs((1, 3, 37, 53), 1, cuda)
    fwd, bwd = pw.pairwise_forward_cuda.launches, pw.pairwise_grad_cuda.launches
    x = logits.requires_grad_(True)
    pw.boxinst_pairwise_loss(x, sim, masks, valid).backward()
    assert pw.pairwise_forward_cuda.launches == fwd + 1
    assert pw.pairwise_grad_cuda.launches == bwd + 1


def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    logits, sim, masks, valid = _inputs((1, 3, 16, 24), 2, cuda)
    with pytest.raises(ValueError, match='float32'):
        pw.pairwise_forward_cuda(logits.double(), sim, masks, valid)
    with pytest.raises(ValueError, match='contiguous'):
        pw.pairwise_forward_cuda(logits.transpose(2, 3), sim, masks, valid)
    with pytest.raises(ValueError, match='bool'):
        pw.pairwise_forward_cuda(logits, sim, masks, valid.float())
    with pytest.raises(ValueError, match='color_sim'):
        pw.pairwise_forward_cuda(logits, sim[:, :4].contiguous(), masks,
                                 valid)
    # a halo of (3 // 2) * 17 = 17 pixels exceeds the kernel tiles' 16:
    # the C side refuses it and the wrapper raises
    with pytest.raises(RuntimeError, match='CUDA error'):
        pw.pairwise_forward_cuda(logits, sim, masks, valid, 0.3, 3, 17)
