"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a GPU. Every test here is marked ``cuda`` and skips without a
CUDA device. This file imports no JAX, so it also runs where only PyTorch
is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances (fp32, summation order): pairwise value rtol 1e-5; gradient
atol 1e-6 / rtol 1e-5 on the unnormalised gradient d(num)/d(logits), whose
entries are O(1). Through autograd the gradient is divided by max(den, 1),
so there the absolute term is divided by it too. MSDA and LCM: atol 1e-5
of the reference's largest entry (1e-5 at least) and rtol 1e-4: the MSDA
d(value) sums with float atomics in an order that changes between runs. The
MSDA pair takes a whole encoder layer (all levels) in one launch each way;
the fast pair (D 32, P 4, 3 levels) and the generic one are both held to
the plain version and to autograd through the plain forward. The Swin window
attention pair K5/K6 is held to the same bound; its dbias sums the windows
in a fixed order, so it gives the same bits from run to run. The CRF fixed
point K7 sums its exact products in the plain version's order: it must give
the plain version's bits.
"""
import numpy as np
import pytest
import torch

from boxinstseg_tpu_torch.models.losses.levelset_loss import \
    LocalConsistencyModule
from boxinstseg_tpu_torch.models.dense_heads.discobox_head import \
    MeanFieldCRF
from boxinstseg_tpu_torch.ops import crf, lcm, msda
from boxinstseg_tpu_torch.ops import pairwise as pw
from boxinstseg_tpu_torch.ops import swin_attention as swa

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


def _close_scaled(got, want):
    ref = want.abs().max().item()
    assert ref > 0.1, 'reference too small for a meaningful check'
    torch.testing.assert_close(got, want, atol=1e-5 * max(ref, 1.0),
                               rtol=1e-4)


def _msda_inputs(seed, device, b, heads, d, p, levels, l, spread):
    """One layer's inputs to ``ms_deform_attn``: ``l`` None gives the
    encoder's queries (reference points at the levels' grid centres,
    offsets of up to 4 cells plus noise); else ``l`` random reference
    points whose samples spread up to ``spread`` map widths outside."""
    rng = np.random.RandomState(seed)
    nl = len(levels)
    s = sum(h * w for h, w in levels)
    size = np.array([[w, h] for h, w in levels])[:, None]
    if l is None:
        ref = np.concatenate([np.stack(np.meshgrid(
            (np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h), -1
        ).reshape(-1, 2) for h, w in levels])[None].repeat(b, 0)
        l = s
        offsets = rng.randint(-4, 5, (b, l, heads, nl, p, 2)) + rng.randn(
            b, l, heads, nl, p, 2)
    else:
        ref = rng.rand(b, l, 2)
        loc = rng.uniform(-spread, 1 + spread, (b, l, heads, nl, p, 2))
        offsets = (loc - ref[:, :, None, None, None]) * size
    logits = rng.randn(b, l, heads, nl * p)
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    arrays = (rng.randn(b, s, heads, d), ref, offsets,
              attn.reshape(b, l, heads, nl, p), rng.randn(b, l, heads * d))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
            for a in arrays]


# one layer of the Box2Mask encoder (batch 2, 8 heads, 32 channels a head,
# 4 points, the 32x32, 64x64 and 128x128 levels of a 1024x1024 canvas;
# fast pair), odd maps with the encoder's queries and with random ones
# (fast pair), and D 48, P 3 on two levels with samples far outside
# (generic pair)
MSDA_CASES = [(2, 8, 32, 4, ((32, 32), (64, 64), (128, 128)), None, 0),
              (1, 3, 32, 4, ((13, 7), (7, 4), (4, 2)), None, 0),
              (1, 3, 32, 4, ((13, 7), (7, 4), (4, 2)), 37, 0.6),
              (2, 1, 48, 3, ((5, 11), (3, 6)), 19, 1.5)]


@pytest.mark.parametrize('case', MSDA_CASES)
def test_msda_kernels_match_plain(cuda, case):
    levels = case[4]
    value, ref, offsets, attn, g = _msda_inputs(0, cuda, *case)
    _close_scaled(msda.msda_forward_cuda(value, levels, ref, offsets, attn),
                  msda.ms_deform_attn_plain(value, levels, ref, offsets,
                                            attn))
    leaves = [t.clone().requires_grad_(True) for t in (value, offsets, attn)]
    plain = torch.autograd.grad(msda.ms_deform_attn_plain(
        leaves[0], levels, ref, leaves[1], leaves[2]), leaves, g)
    autograd = torch.autograd.grad(msda.ms_deform_attn_plain(
        leaves[0], levels, ref, leaves[1], leaves[2],
        sample=msda.msda_forward_plain), leaves, g)
    got = msda.msda_backward_cuda(value, levels, ref, offsets, attn, g)
    for gk, gp, ga in zip(got, plain, autograd):
        _close_scaled(gk, gp)
        _close_scaled(gk, ga)


def _lcm_inputs(seed, device, shape):
    rng = np.random.RandomState(seed)
    b = shape[0]
    module = LocalConsistencyModule(dilations=(2,), num_iter=10)
    imgs = torch.from_numpy(rng.rand(b, 3, *shape[2:]).astype(np.float32))
    aff = module.affinity(imgs.to(device)).contiguous()
    x, y = (torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device)
            for _ in range(2))
    return module.offsets(), aff, x, y


# the Box2Mask shape (10 outputs x 8 GT slots at 96x96) and planes that
# are odd or smaller than the dilation-2 offsets
@pytest.mark.parametrize('shape', [(2, 80, 96, 96), (1, 3, 37, 53),
                                   (2, 5, 3, 5)])
def test_lcm_kernels_match_plain_and_are_adjoint(cuda, shape):
    offs, aff, x, y = _lcm_inputs(1, cuda, shape)
    ax = lcm.lcm_forward_cuda(aff, x, offs, 10)
    aty = lcm.lcm_adjoint_cuda(aff, y, offs, 10)
    _close_scaled(ax, lcm.lcm_forward_plain(aff, x, offs, 10))
    _close_scaled(aty, lcm.lcm_adjoint_plain(aff, y, offs, 10))
    lhs = (ax.double() * y.double()).sum().item()
    rhs = (x.double() * aty.double()).sum().item()
    assert lhs == pytest.approx(rhs, rel=1e-5)


def test_box2mask_ops_launch_kernels_for_cuda_tensors(cuda):
    from boxinstseg_tpu_torch.models.utils.transformer import \
        MultiScaleDeformableAttention
    levels = ((6, 5), (3, 3))
    value, ref, _, _, _ = _msda_inputs(2, cuda, 2, 8, 32, 4, levels, None, 0)
    module = MultiScaleDeformableAttention(256, 8, 2, 4).to(cuda)
    x = value.reshape(2, -1, 256).requires_grad_(True)
    fwd, bwd = msda.msda_forward_cuda.launches, msda.msda_backward_cuda.launches
    module(x, x, levels, ref).sum().backward()
    assert (msda.msda_forward_cuda.launches,
            msda.msda_backward_cuda.launches) == (fwd + 1, bwd + 1)
    assert module.sampling_offsets.weight.grad.abs().max() > 0
    offs, aff, x, _ = _lcm_inputs(3, cuda, (1, 2, 9, 11))
    fwd, adj = lcm.lcm_forward_cuda.launches, lcm.lcm_adjoint_cuda.launches
    x.requires_grad_(True)
    lcm.lcm_refine(aff, x, offs, 10).sum().backward()
    assert (lcm.lcm_forward_cuda.launches,
            lcm.lcm_adjoint_cuda.launches) == (fwd + 1, adj + 1)


def test_box2mask_wrappers_reject_what_they_do_not_take(cuda):
    levels = ((6, 5), (3, 3))
    value, ref, offsets, attn, g = _msda_inputs(4, cuda, 2, 2, 32, 2, levels,
                                                7, 0.2)
    with pytest.raises(ValueError, match='float32'):
        msda.msda_forward_cuda(value.double(), levels, ref, offsets, attn)
    with pytest.raises(ValueError, match='do not tile'):
        msda.msda_forward_cuda(value, ((6, 5), (3, 2)), ref, offsets, attn)
    with pytest.raises(ValueError, match='is on cpu'):
        msda.msda_forward_cuda(value, levels, ref.cpu(), offsets, attn)
    with pytest.raises(ValueError, match='contiguous'):
        msda.msda_backward_cuda(value, levels, ref, offsets, attn,
                                g.transpose(0, 1).contiguous().transpose(0, 1))
    shifted = torch.empty(offsets.numel() + 1, device=cuda)[1:]
    with pytest.raises(ValueError, match='16-byte'):
        msda.msda_forward_cuda(value, levels, ref,
                               shifted.view(offsets.shape).copy_(offsets),
                               attn)
    with pytest.raises(ValueError, match='must not require grad'):
        msda.ms_deform_attn(value, levels, ref.requires_grad_(True), offsets,
                            attn)
    with pytest.raises(ValueError, match='ms_deform_attn'):
        msda.msda_sample_psum_pm(value[:, :30].reshape(2, 6, 5, 64),
                                 ref[..., 0], ref[..., 1], ref[..., 0], 1)
    offs, aff, x, _ = _lcm_inputs(5, cuda, (1, 2, 9, 11))
    with pytest.raises(ValueError, match='contiguous'):
        lcm.lcm_forward_cuda(aff, x.transpose(2, 3), offs, 10)
    big = torch.zeros((1, 1, 200, 200), device=cuda)
    with pytest.raises(ValueError, match='shared memory'):
        lcm.lcm_forward_cuda(torch.zeros((1, 8, 200, 200), device=cuda), big,
                             offs, 10)


def _swin_inputs(seed, device, hp, wp, ws, shift, images, heads, d,
                 region_ids=None):
    rng = np.random.RandomState(seed)
    regions = swa.shift_regions(hp, wp, ws, shift)
    if region_ids:
        regions = rng.randint(0, region_ids, regions.shape).astype(np.int32)
    nw, _, n = regions.shape
    qkv, g = (rng.randn(images * nw, n, c).astype(np.float32)
              for c in (3 * heads * d, heads * d))
    bias = rng.randn(heads, n, n).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (qkv, bias, regions, g)]


# (hp, wp, window, shift, images, heads, head dim, random region ids): a
# shifted stage-1 block of Swin-T (window 7), a small ragged case with three
# region ids, Swin-L's stage-3 shape (window 12, 48 heads); the edges of the
# kernels' tiling: window 4 (N = 16, one warp) at head dims 8 and 16 (both
# padded to 32 columns), Swin-T's stage 0 at 224x224 (128 windows of 49
# tokens), Swin-L's stage 1 (121 windows, 12 heads: blocks walk 11 windows)
# and stage 2 (36 windows over 5 groups: some walk 8, some 7), window 12
# with random region ids, and head dim 6 (rows copied 4 bytes at a time)
@pytest.mark.parametrize('case', [(14, 21, 7, 3, 1, 6, 32, 0),
                                  (8, 12, 4, 0, 2, 2, 8, 3),
                                  (36, 36, 12, 6, 1, 48, 32, 0),
                                  (8, 12, 4, 2, 2, 3, 8, 0),
                                  (12, 8, 4, 0, 1, 2, 16, 2),
                                  (56, 56, 7, 3, 2, 3, 32, 0),
                                  (132, 132, 12, 6, 1, 12, 32, 0),
                                  (72, 72, 12, 0, 1, 24, 32, 0),
                                  (24, 36, 12, 0, 2, 4, 32, 5),
                                  (8, 12, 4, 0, 1, 2, 6, 0)])
def test_swin_attention_kernels_match_plain(cuda, case):
    qkv, bias, regions, g = _swin_inputs(0, cuda, *case)
    scale = case[6] ** -0.5
    c = qkv.shape[-1] // 3
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    _close_scaled(swa.window_attention_forward_cuda(q, k, v, bias, regions,
                                                    scale),
                  swa.window_attention_plain(q, k, v, bias, regions, scale))
    dqkv, dbias = swa.window_attention_backward_cuda(q, k, v, bias, regions,
                                                     scale, g)
    want = swa.window_attention_backward_plain(q, k, v, bias, regions, scale,
                                               g)
    for got, ref in zip((dqkv[..., :c], dqkv[..., c:2 * c],
                         dqkv[..., 2 * c:], dbias), want):
        _close_scaled(got, ref)
    # the same bits on a second run: dbias sums the windows in a fixed order
    again = swa.window_attention_backward_cuda(q, k, v, bias, regions, scale,
                                               g)
    assert torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)


def test_swin_attention_launches_kernels_for_cuda_tensors(cuda):
    qkv, bias, regions, g = _swin_inputs(1, cuda, 8, 8, 4, 2, 2, 2, 16)
    fwd = swa.window_attention_forward_cuda.launches
    bwd = swa.window_attention_backward_cuda.launches
    qkv.requires_grad_(True)
    bias.requires_grad_(True)
    swa.window_attention_qkv(qkv, bias, regions, 0.25).backward(g)
    assert (swa.window_attention_forward_cuda.launches,
            swa.window_attention_backward_cuda.launches) == (fwd + 1, bwd + 1)
    leaves = [t.detach().cpu().requires_grad_(True) for t in (qkv, bias)]
    swa.window_attention_qkv(leaves[0], leaves[1], regions.cpu(),
                             0.25).backward(g.cpu())
    _close_scaled(qkv.grad.cpu(), leaves[0].grad)
    _close_scaled(bias.grad.cpu(), leaves[1].grad)


def test_swin_attention_wrappers_reject_what_they_do_not_take(cuda):
    qkv, bias, regions, g = _swin_inputs(2, cuda, 8, 8, 4, 2, 1, 2, 8)
    c = qkv.shape[-1] // 3
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    with pytest.raises(ValueError, match='int32'):
        swa.window_attention_forward_cuda(q, k, v, bias, regions.long(), 1.0)
    with pytest.raises(ValueError, match='whole images'):
        swa.window_attention_forward_cuda(q, k, v, bias, regions[:3], 1.0)
    with pytest.raises(ValueError, match='row stride'):
        swa.window_attention_forward_cuda(q, k.contiguous(), v, bias,
                                          regions, 1.0)
    with pytest.raises(ValueError, match='CUDA'):
        swa.window_attention_forward_cuda(q, k, v, bias.cpu(), regions, 1.0)
    # window 15: N = 225 fits the forward (bias read from L2); the
    # backward's dbias accumulator does not fit beside its staged operands
    big = _swin_inputs(3, cuda, 15, 15, 15, 0, 1, 1, 32)
    c = big[0].shape[-1] // 3
    qb, kb, vb = big[0][..., :c], big[0][..., c:2 * c], big[0][..., 2 * c:]
    swa.window_attention_forward_cuda(qb, kb, vb, big[1], big[2], 1.0)
    with pytest.raises(ValueError, match='shared memory'):
        swa.window_attention_backward_cuda(qb, kb, vb, big[1], big[2], 1.0,
                                           big[3])


def _crf_inputs(seed, device, b, k, h, w):
    """K7's inputs as DiscoBox makes them: the kernel of a blocky image
    (flat 8x8 blocks plus noise, so that neighbours vote), its threshold,
    and box targets with random scores inside; with more than one plane
    an image, the last plane of image 0 has no target."""
    rng = np.random.RandomState(seed)
    blocks = rng.rand(b, 3, h // 8 + 1, w // 8 + 1).astype(np.float32)
    img = np.repeat(np.repeat(blocks, 8, 2), 8, 3)[:, :, :h, :w] \
        + rng.rand(b, 3, h, w).astype(np.float32) * 0.05
    kern = MeanFieldCRF().build_kernel(torch.from_numpy(img))
    targets = np.zeros((b, k, h, w), np.float32)
    for i in range(b):
        for j in range(k):
            y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
            targets[i, j, y:y + rng.randint(2, h // 2 + 2),
                    x:x + rng.randint(2, w // 2 + 2)] = 1
    if k > 1:
        targets[0, -1] = 0
    bin0 = ((rng.rand(b, k, h, w) * targets) > 0.5).astype(np.float32)
    out = [kern, 0.5 * crf.kernel_sum(kern), torch.from_numpy(bin0),
           torch.from_numpy(targets)]
    return [t.contiguous().to(device) for t in out]


# the main path's shape (batch 2, max_pos 128, 800x1344 / 4), its
# transpose, and ragged ones: odd maps, K = 1 and 5, three images
@pytest.mark.parametrize('shape', [(2, 128, 200, 336), (2, 128, 336, 200),
                                   (1, 1, 37, 53), (1, 5, 37, 53),
                                   (3, 5, 37, 53)])
def test_crf_kernel_equals_plain_bitwise(cuda, shape):
    kern, thresh, bin0, targets = _crf_inputs(6, cuda, *shape)
    got = crf.crf_mean_field_cuda(kern, thresh, bin0, targets, 10)
    want = crf.crf_mean_field_plain(kern, thresh, bin0, targets, 10)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not torch.equal(want, bin0)        # the rounds changed labels
    assert shape[1] == 1 or not want[0, -1].any()
    # no rounds: the initial state
    assert torch.equal(crf.crf_mean_field_cuda(kern, thresh, bin0, targets,
                                               0), bin0)


def test_crf_dispatch_launches_the_kernel_for_cuda_tensors(cuda):
    kern, thresh, bin0, targets = _crf_inputs(7, cuda, 2, 3, 24, 40)
    x = torch.rand(bin0.shape, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    before = crf.crf_mean_field_cuda.launches
    got = MeanFieldCRF(num_iter=5)(kern, x, targets)
    assert crf.crf_mean_field_cuda.launches == before + 1
    want = MeanFieldCRF(num_iter=5)(kern.cpu(), x.cpu(), targets.cpu())
    assert crf.crf_mean_field_cuda.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_crf_wrapper_rejects_what_it_does_not_take(cuda):
    kern, thresh, bin0, targets = _crf_inputs(8, cuda, 1, 2, 16, 16)
    with pytest.raises(ValueError, match='3x3'):
        crf.crf_mean_field_cuda(kern, thresh, bin0, targets, 10,
                                kernel_size=5)
    with pytest.raises(ValueError, match='CUDA'):
        crf.crf_mean_field_cuda(kern, thresh.cpu(), bin0, targets, 10)
    with pytest.raises(ValueError, match='float32'):
        crf.crf_mean_field_cuda(kern, thresh, bin0.double(), targets, 10)
    with pytest.raises(ValueError, match='contiguous'):
        crf.crf_mean_field_cuda(kern, thresh, bin0.transpose(2, 3),
                                targets.transpose(2, 3), 10)
    big = torch.zeros((1, 1, 400, 400), device=cuda)
    with pytest.raises(ValueError, match='shared memory'):
        crf.crf_mean_field_cuda(torch.zeros((1, 9, 400, 400), device=cuda),
                                torch.zeros((1, 400, 400), device=cuda), big,
                                big, 10)
