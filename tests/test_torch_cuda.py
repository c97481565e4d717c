"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a GPU. Every test here is marked ``cuda`` and skips without a
CUDA device. This file imports no JAX, so it also runs where only PyTorch
is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances (fp32, summation order): pairwise value rtol 1e-5 (den
exact); gradient atol 1e-6 / rtol 1e-5 on the unnormalised gradient
d(num)/d(logits), whose entries are O(1); the pairwise pair also on box
bitmasks (the inputs of ``tests/test_torch_pairwise_plan.py``), at every
instance chunk and tile height it takes, and bit for bit from call to
call. Through autograd the gradient is divided by max(den, 1),
so there the absolute term is divided by it too. MSDA and LCM: atol 1e-5
of the reference's largest entry (1e-5 at least) and rtol 1e-4: the MSDA
d(value) sums with float atomics in an order that changes between runs. The
MSDA pair takes a whole encoder layer (all levels) in one launch each way;
the fast pair (D 32, P 4, 3 levels) and the generic one are both held to
the plain version and to autograd through the plain forward. The Swin window
attention pair K5/K6 is held to the same bound; its dbias sums the windows
in a fixed order, so it gives the same bits from run to run. The CRF fixed
point K7 sums its exact products in the plain version's order: it must give
the plain version's bits. The LSA and the grid MST kernels compute integers
(an assignment; parents and depths): they must equal their plain versions
element for element, the MST at 9x11, 16x16 and 96x96 (flat-block ties and
distinct weights, uncapped and under a binding depth cap), on negative
weights, signed zeros and NaN, and the MST wrapper must refuse a grid past
its shared-memory limit. Each kernel's launches are counted in
``utils.profiling.COUNTS``, and the host syncs of a recorded block by their
call site.
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
from boxinstseg_tpu_torch.utils.profiling import COUNTS
from test_torch_pairwise_plan import BOX_SHAPES, box_inputs, gate_sim

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
    vk = pw.boxinst_pairwise_loss(xk, sim, masks, valid, 0.3, 3, 2)
    vk.backward()
    one = torch.ones(1, device=cuda)
    g_kernel = pw.pairwise_grad_cuda(logits, sim, masks, valid, one)
    g_plain = pw.pairwise_grad_plain(logits, sim, masks, valid)
    num, den = pw.pairwise_num_den_plain(logits, sim, masks, valid)
    # the plain version's loss and its analytic gradient through the
    # normaliser, as the op's CPU implementation computes them
    den = den.clamp(min=1.0)
    vp, xp_grad = num / den, g_plain * (1.0 / den)
    torch.cuda.synchronize()
    assert vk.item() == pytest.approx(vp.item(), rel=1e-5)
    assert g_plain.abs().max().item() > 0.1
    torch.testing.assert_close(g_kernel, g_plain, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(xk.grad, xp_grad,
                               atol=1e-6 / den.item(), rtol=1e-5)


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
    fwd, bwd = (COUNTS['kernel.pairwise_forward'],
                COUNTS['kernel.pairwise_backward'])
    x = logits.requires_grad_(True)
    pw.boxinst_pairwise_loss(x, sim, masks, valid).backward()
    assert COUNTS['kernel.pairwise_forward'] == fwd + 1
    assert COUNTS['kernel.pairwise_backward'] == bwd + 1


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
    # a live map that K1 did not make for these inputs
    with pytest.raises(ValueError, match='live'):
        pw.pairwise_grad_cuda(logits, sim, masks, valid,
                              torch.ones(1, device=cuda),
                              live=torch.ones(3, dtype=torch.uint8,
                                              device=cuda))


def _box_case(shape, kernel_size, copies, device):
    """``copies`` draws of the six box instances an image, one after the
    other along K: 6, 18 or 36 instances, in K1's chunks of 16 and K2's of
    8 (a short last chunk each)."""
    draws = [box_inputs(shape, 7 + c) for c in range(copies)]
    logits, masks, valid = (np.concatenate([d[i] for d in draws], 1)
                            for i in (0, 2, 3))
    sim = gate_sim(draws[0][1], kernel_size).numpy()
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in
            (logits, sim, masks, valid)]


# box bitmasks (a box inside one tile, a frame on every border, an empty
# and an invalid instance, the whole plane, a box across tiles) at the main
# path's stencil (the fast kernels) and generic ones, W a multiple of 4 or
# not; 6, 18 and 36 instances an image
@pytest.mark.parametrize('copies', [1, 3, 6])
@pytest.mark.parametrize('shape,kernel_size,dilation', BOX_SHAPES)
def test_pairwise_kernels_on_boxes_match_plain(cuda, shape, kernel_size,
                                               dilation, copies):
    x, sim, bm, valid = _box_case(shape, kernel_size, copies, cuda)
    cfg = (0.3, kernel_size, dilation)
    num, den = pw.pairwise_forward_cuda(x, sim, bm, valid, *cfg)
    want_num, want_den = pw.pairwise_num_den_plain(x, sim, bm, valid, *cfg)
    assert num.item() == pytest.approx(want_num.item(), rel=1e-5)
    assert den.item() == want_den.item()
    one = torch.ones(1, device=cuda)
    grad = pw.pairwise_grad_cuda(x, sim, bm, valid, one, *cfg)
    want = pw.pairwise_grad_plain(x, sim, bm, valid, *cfg)
    assert want.abs().max().item() > 0.1
    torch.testing.assert_close(grad, want, atol=1e-6, rtol=1e-5)
    assert not grad[:, 2::6].any() and not grad[:, 3::6].any()
    # K2 led by K1's live map finds the same work as by its own vote
    *sums, live = pw.pairwise_forward_cuda(x, sim, bm, valid, *cfg,
                                           keep_live=True)
    assert torch.equal(torch.stack(sums), torch.stack([num, den]))
    b, k = x.shape[:2]
    tiles = live.reshape(b, k, -1)
    r = kernel_size // 2 * dilation
    assert torch.equal(tiles.bool(), pw.live_tiles(
        bm, valid, r, r, r).reshape(b, k, -1))
    assert torch.equal(pw.pairwise_grad_cuda(x, sim, bm, valid, one, *cfg,
                                             live=live), grad)


# K = 13 in chunks of 8: a short last chunk; the sum and the gradient come
# back with the same bits (no float atomics; K1's partials summed in order)
def test_pairwise_kernels_give_the_same_bits_twice(cuda):
    x, sim, bm, valid = _inputs((2, 13, 45, 70), 4, cuda)
    one = torch.ones(1, device=cuda)
    first = torch.stack(pw.pairwise_forward_cuda(x, sim, bm, valid))
    grad = pw.pairwise_grad_cuda(x, sim, bm, valid, one)
    for _ in range(3):
        assert torch.equal(torch.stack(pw.pairwise_forward_cuda(
            x, sim, bm, valid)), first)
        assert torch.equal(pw.pairwise_grad_cuda(x, sim, bm, valid, one),
                           grad)
    want_num, want_den = pw.pairwise_num_den_plain(x, sim, bm, valid)
    assert first[0].item() == pytest.approx(want_num.item(), rel=1e-5)
    assert first[1].item() == want_den.item()


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


def _lcm_inputs(seed, device, shape, dilations=(2,)):
    rng = np.random.RandomState(seed)
    b = shape[0]
    module = LocalConsistencyModule(dilations=dilations, num_iter=10)
    imgs = torch.from_numpy(rng.rand(b, 3, *shape[2:]).astype(np.float32))
    aff = module.affinity(imgs.to(device)).contiguous()
    x, y = (torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device)
            for _ in range(2))
    return module.offsets(), aff, x, y


# the Box2Mask shape (10 outputs x 8 GT slots at 96x96); planes that are
# odd or smaller than the dilation-2 offsets; 83 channels (a short last
# channel group); 130 rows (six bands, the last shorter); 208 rows of 96
# (eight bands, the ring kernel's limit) and 209 (the generic kernel); a
# non-ring offset set (dilations 1 and 2: the generic kernel); 0 and 1
# rounds
@pytest.mark.parametrize('shape, dilations, rounds', [
    ((2, 80, 96, 96), (2,), 10), ((1, 3, 37, 53), (2,), 10),
    ((2, 5, 3, 5), (2,), 10), ((2, 83, 96, 96), (2,), 10),
    ((1, 3, 130, 100), (2,), 10), ((1, 2, 208, 96), (2,), 10),
    ((1, 2, 209, 96), (2,), 10), ((1, 3, 37, 53), (1, 2), 10),
    ((1, 3, 37, 53), (2,), 0), ((1, 3, 37, 53), (2,), 1)])
def test_lcm_kernels_match_plain_and_are_adjoint(cuda, shape, dilations,
                                                 rounds):
    offs, aff, x, y = _lcm_inputs(1, cuda, shape, dilations)
    ax = lcm.lcm_forward_cuda(aff, x, offs, rounds)
    aty = lcm.lcm_adjoint_cuda(aff, y, offs, rounds)
    _close_scaled(ax, lcm.lcm_forward_plain(aff, x, offs, rounds))
    _close_scaled(aty, lcm.lcm_adjoint_plain(aff, y, offs, rounds))
    lhs = (ax.double() * y.double()).sum().item()
    rhs = (x.double() * aty.double()).sum().item()
    assert lhs == pytest.approx(rhs, rel=1e-5)
    ring = lcm.launch_plan(x, offs, True)
    assert (ring is None) == (dilations != (2,) or shape[2] == 209)


def test_box2mask_ops_launch_kernels_for_cuda_tensors(cuda):
    from boxinstseg_tpu_torch.models.utils.transformer import \
        MultiScaleDeformableAttention
    levels = ((6, 5), (3, 3))
    value, ref, _, _, _ = _msda_inputs(2, cuda, 2, 8, 32, 4, levels, None, 0)
    module = MultiScaleDeformableAttention(256, 8, 2, 4).to(cuda)
    x = value.reshape(2, -1, 256).requires_grad_(True)
    fwd, bwd = COUNTS['kernel.msda_forward'], COUNTS['kernel.msda_backward']
    module(x, x, levels, ref).sum().backward()
    assert (COUNTS['kernel.msda_forward'],
            COUNTS['kernel.msda_backward']) == (fwd + 1, bwd + 1)
    assert module.sampling_offsets.weight.grad.abs().max() > 0
    offs, aff, x, _ = _lcm_inputs(3, cuda, (1, 2, 9, 11))
    fwd, adj = COUNTS['kernel.lcm_forward'], COUNTS['kernel.lcm_adjoint']
    x.requires_grad_(True)
    lcm.lcm_refine(aff, x, offs, 10).sum().backward()
    assert (COUNTS['kernel.lcm_forward'],
            COUNTS['kernel.lcm_adjoint']) == (fwd + 1, adj + 1)


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
    for h, w in ((200, 200), (400, 96)):
        big = torch.zeros((1, 1, h, w), device=cuda)
        with pytest.raises(ValueError, match='shared memory'):
            lcm.lcm_forward_cuda(torch.zeros((1, 8, h, w), device=cuda), big,
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
# with random region ids, and head dim 6 (rows copied 4 bytes at a time);
# past window 12, where the backward adds dS into its partial slice: window
# 14 (N = 196) shifted, window 16 (N = 256, Swin-L's stage-2 width) and
# window 15 (N = 225, odd rows); window 12 at head dim 64 (N = 144, dS into
# the partial, every operand staged); where it also reads g from L2: window
# 16 at head dim 64 and window 12 at head dim 128
@pytest.mark.parametrize('case', [(14, 21, 7, 3, 1, 6, 32, 0),
                                  (8, 12, 4, 0, 2, 2, 8, 3),
                                  (36, 36, 12, 6, 1, 48, 32, 0),
                                  (8, 12, 4, 2, 2, 3, 8, 0),
                                  (12, 8, 4, 0, 1, 2, 16, 2),
                                  (56, 56, 7, 3, 2, 3, 32, 0),
                                  (132, 132, 12, 6, 1, 12, 32, 0),
                                  (72, 72, 12, 0, 1, 24, 32, 0),
                                  (24, 36, 12, 0, 2, 4, 32, 5),
                                  (8, 12, 4, 0, 1, 2, 6, 0),
                                  (28, 42, 14, 7, 1, 4, 32, 0),
                                  (32, 32, 16, 8, 1, 3, 32, 0),
                                  (15, 30, 15, 0, 1, 2, 32, 3),
                                  (24, 24, 12, 6, 1, 2, 64, 0),
                                  (32, 16, 16, 0, 2, 2, 64, 0),
                                  (24, 24, 12, 6, 1, 2, 128, 0)])
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
    fwd = COUNTS['kernel.window_attention_forward']
    bwd = COUNTS['kernel.window_attention_backward']
    qkv.requires_grad_(True)
    bias.requires_grad_(True)
    swa.window_attention_qkv(qkv, bias, regions, 0.25).backward(g)
    assert (COUNTS['kernel.window_attention_forward'],
            COUNTS['kernel.window_attention_backward']) == (fwd + 1, bwd + 1)
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
    # window 16 at head dim 128: N = 256 fits neither kernel's shared
    # memory (three staged 256 x 132 operands); both refuse it
    big = _swin_inputs(3, cuda, 16, 16, 16, 0, 1, 1, 128)
    c = big[0].shape[-1] // 3
    qb, kb, vb = big[0][..., :c], big[0][..., c:2 * c], big[0][..., 2 * c:]
    with pytest.raises(ValueError, match='shared memory'):
        swa.window_attention_forward_cuda(qb, kb, vb, big[1], big[2], 1.0)
    with pytest.raises(ValueError, match='shared memory'):
        swa.window_attention_backward_cuda(qb, kb, vb, big[1], big[2], 1.0,
                                           big[3])


def _crf_inputs(seed, device, b, k, h, w, full=False):
    """K7's inputs as DiscoBox makes them: the kernel of a blocky image
    (flat 8x8 blocks plus noise, so that neighbours vote), its threshold,
    and box targets with random scores inside; with more than one plane
    an image, the last plane of image 0 has no target; with ``full``,
    plane 0 of every image is a target everywhere (every border)."""
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
    if full:
        targets[:, 0] = 1
    if k > 1:
        targets[0, -1] = 0
    bin0 = ((rng.rand(b, k, h, w) * targets) > 0.5).astype(np.float32)
    out = [kern, 0.5 * crf.kernel_sum(kern), torch.from_numpy(bin0),
           torch.from_numpy(targets)]
    return [t.contiguous().to(device) for t in out]


# the main path's shape (batch 2, max_pos 128, 800x1344 / 4), its
# transpose, and ragged ones: odd maps (bands with a short last one),
# K = 1, 5 and 13 (a short last group of 8 planes), three images, a
# target plane touching every border, a plane without a target
@pytest.mark.parametrize('shape, full', [
    ((2, 128, 200, 336), False), ((2, 128, 336, 200), False),
    ((1, 1, 37, 53), False), ((1, 5, 37, 53), False),
    ((3, 5, 37, 53), False), ((2, 13, 37, 53), True),
    ((1, 5, 37, 53), True)])
def test_crf_kernel_equals_plain_bitwise(cuda, shape, full):
    kern, thresh, bin0, targets = _crf_inputs(6, cuda, *shape, full=full)
    for rounds in (10, 1):
        got = crf.crf_mean_field_cuda(kern, thresh, bin0, targets, rounds)
        want = crf.crf_mean_field_plain(kern, thresh, bin0, targets, rounds)
        torch.cuda.synchronize()
        assert torch.equal(got, want), rounds
        assert not torch.equal(want, bin0)    # the rounds changed labels
    assert shape[1] == 1 or not want[0, -1].any()
    # no rounds: the initial state
    assert torch.equal(crf.crf_mean_field_cuda(kern, thresh, bin0, targets,
                                               0), bin0)


def test_crf_dispatch_launches_the_kernel_for_cuda_tensors(cuda):
    kern, thresh, bin0, targets = _crf_inputs(7, cuda, 2, 3, 24, 40)
    x = torch.rand(bin0.shape, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    before = COUNTS['kernel.crf_mean_field']
    got = MeanFieldCRF(num_iter=5)(kern, x, targets)
    assert COUNTS['kernel.crf_mean_field'] == before + 1
    want = MeanFieldCRF(num_iter=5)(kern.cpu(), x.cpu(), targets.cpu())
    assert COUNTS['kernel.crf_mean_field'] == before + 1
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
    # more than 8 bands of rows
    big = torch.zeros((1, 1, 1200, 1200), device=cuda)
    with pytest.raises(ValueError, match='shared memory'):
        crf.crf_mean_field_cuda(torch.zeros((1, 9, 1200, 1200), device=cuda),
                                torch.zeros((1, 1200, 1200), device=cuda),
                                big, big, 10)


def _launches():
    return (COUNTS['kernel.pairwise_forward'],
            COUNTS['kernel.pairwise_backward'],
            COUNTS['kernel.msda_forward'], COUNTS['kernel.msda_backward'],
            COUNTS['kernel.lcm_forward'], COUNTS['kernel.lcm_adjoint'],
            COUNTS['kernel.window_attention_forward'],
            COUNTS['kernel.window_attention_backward'],
            COUNTS['kernel.crf_mean_field'])


def _bf16_case(kind, cuda):
    """(the kernel's entry, its bf16 inputs, how many of them (the first)
    get a gradient, the launch counters it moves)."""
    if kind == 'pairwise':
        logits, sim, masks, valid = _inputs((1, 3, 37, 53), 9, cuda)
        leaves = [logits.bfloat16(), sim.bfloat16(), masks.bfloat16()]

        def run(x, s, m):
            return pw.boxinst_pairwise_loss(x, s, m, valid, 0.3, 3, 2)
        return run, leaves, 1, (0, 1)
    if kind == 'msda':
        levels = ((6, 5), (3, 3))
        value, ref, offsets, attn, _ = _msda_inputs(9, cuda, 2, 2, 32, 4,
                                                    levels, 7, 0.2)
        leaves = [value.bfloat16(), offsets.bfloat16(), attn.bfloat16()]

        def run(v, o, a):
            return msda.ms_deform_attn(v, levels, ref, o, a)
        return run, leaves, 3, (2, 3)
    if kind == 'lcm':
        offs, aff, x, _ = _lcm_inputs(9, cuda, (1, 3, 37, 53))
        leaves = [x.bfloat16()]

        def run(p):
            return lcm.lcm_refine(aff.bfloat16(), p, offs, 10)
        return run, leaves, 1, (4, 5)
    if kind == 'swin':
        qkv, bias, regions, _ = _swin_inputs(9, cuda, 8, 8, 4, 2, 2, 2, 16)
        leaves = [qkv.bfloat16(), bias.bfloat16()]

        def run(q, b):
            return swa.window_attention_qkv(q, b, regions, 0.25)
        return run, leaves, 2, (6, 7)
    kern, thresh, bin0, targets = _crf_inputs(9, cuda, 1, 5, 37, 53)
    leaves = [kern.bfloat16(), thresh.bfloat16(), bin0.bfloat16(),
              targets.bfloat16()]

    def run(k, t, b, g):
        return crf.crf_mean_field(k, t, b, g, 10)
    return run, leaves, 0, (8,)


# autocast leaves the kernels' inputs in bf16 (the DiscoBox config's
# precision key): each entry casts them to fp32, launches its kernel (no
# plain version, no error) and answers in its input's dtype, with the
# gradients in their leaves' dtypes
@pytest.mark.parametrize('kind', ['pairwise', 'msda', 'lcm', 'swin', 'crf'])
def test_kernel_entries_take_bf16_inputs(cuda, kind):
    run, leaves, n_grad, moved = _bf16_case(kind, cuda)
    grads = n_grad > 0
    bf = [t.clone().requires_grad_(i < n_grad)
          for i, t in enumerate(leaves)]
    before = _launches()
    out = run(*bf)
    if grads:
        out.float().sum().backward()
    after = _launches()
    assert [a - b for a, b in zip(after, before)] == [
        (1 if i in moved else 0) for i in range(len(before))]
    assert out.dtype == torch.bfloat16
    f32 = [t.detach().float().requires_grad_(t.requires_grad) for t in bf]
    want = run(*f32)
    torch.testing.assert_close(out.float(), want.to(torch.bfloat16).float())
    if grads:
        want.float().sum().backward()
        for b, f in zip(bf, f32):
            if b.requires_grad:
                assert b.grad.dtype == torch.bfloat16
                torch.testing.assert_close(
                    b.grad.float(), f.grad.to(torch.bfloat16).float(),
                    atol=1e-2 * max(f.grad.abs().max().item(), 1e-3),
                    rtol=1e-2)


def _lsa_cases(seed):
    """(cost, n_rows) of the LSA kernel's cases: random padded problems,
    a crowded full capacity, and integer costs with many exact ties."""
    rng = np.random.RandomState(seed)
    rand = rng.randn(20, 30, 100).astype(np.float32)
    crowded = (rng.randn(20, 100, 100) * 3).astype(np.float32)
    tied = rng.randint(0, 3, (20, 40, 60)).astype(np.float32)
    return [(rand, rng.randint(0, 31, 20)),
            (crowded, np.full(20, 100)),
            (tied, rng.randint(20, 41, 20))]


@pytest.mark.parametrize('case', [0, 1, 2])
def test_lsa_kernel_equals_plain(cuda, case):
    from boxinstseg_tpu_torch.ops import lsa
    cost, n_rows = _lsa_cases(0)[case]
    c = torch.from_numpy(cost)
    nr = torch.from_numpy(n_rows.astype(np.int32))
    want, steps = lsa.solve_lsa_plain(c, nr, return_steps=True)
    before = COUNTS['kernel.lsa']
    got_steps = torch.zeros(len(n_rows), dtype=torch.int32, device=cuda)
    got = lsa.solve_lsa_cuda(c.to(cuda), nr.to(cuda), got_steps)
    torch.cuda.synchronize()
    assert COUNTS['kernel.lsa'] == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got_steps.cpu().long(), steps)
    assert torch.equal(lsa.solve_lsa(c.to(cuda), nr.to(cuda)).cpu(), want)


def test_lsa_wrapper_rejects_what_it_does_not_take(cuda):
    from boxinstseg_tpu_torch.ops import lsa
    nr = torch.ones(2, dtype=torch.int32, device=cuda)
    for cost, n_rows in (
            (torch.zeros(2, 5, 4, device=cuda), nr),             # n > m
            (torch.zeros(2, 3, 4, device=cuda, dtype=torch.float64), nr),
            (torch.zeros(2, 4, 3, device=cuda).transpose(1, 2), nr),
            (torch.zeros(2, 3, 4, device=cuda), nr.long()),
            (torch.zeros(2, 300, 300, device=cuda),
             torch.ones(2, dtype=torch.int32, device=cuda))):
        with pytest.raises(ValueError):
            lsa.solve_lsa_cuda(cost, n_rows)


def _mst_weights(case, seed):
    """(w_right, w_down) of four trees: squared differences of a flat
    3x3-block guide (many exact ties, most of them 0) or of a random one
    (distinct weights), as the heads' tree filter makes them."""
    b, h, w, kind = case
    rng = np.random.RandomState(seed)
    if kind == 'blocks':
        blocks = rng.randint(0, 3, (b, h // 3 + 1, w // 3 + 1, 3))
        g = np.repeat(np.repeat(blocks, 3, 1), 3, 2)[:, :h, :w] * 0.5
    else:
        g = rng.rand(b, h, w, 3)
    g = g.astype(np.float32)
    return (torch.from_numpy(((g[:, :, 1:] - g[:, :, :-1]) ** 2).sum(-1)),
            torch.from_numpy(((g[:, 1:] - g[:, :-1]) ** 2).sum(-1)))


@pytest.mark.parametrize('case', [(4, 9, 11, 'blocks'), (4, 16, 16, 'random'),
                                  (4, 96, 96, 'blocks'),
                                  (8, 96, 96, 'random')])
@pytest.mark.parametrize('capped', [False, True])
def test_mst_kernel_equals_plain(cuda, case, capped):
    from boxinstseg_tpu_torch.ops import mst
    wr, wd = _mst_weights(case, 0)
    n = case[1] * case[2]
    md = max(n // 40, 3) if capped else n
    want = mst.grid_mst_plain(wr, wd, md)
    before = COUNTS['kernel.grid_mst']
    stats = torch.zeros((case[0], 2), dtype=torch.int32, device=cuda)
    got = mst.grid_mst_cuda(wr.to(cuda), wd.to(cuda), md, stats)
    torch.cuda.synchronize()
    assert COUNTS['kernel.grid_mst'] == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    if capped:
        assert int(want[1].max()) == md
        assert (stats[:, 1].cpu() == md).all()
    else:
        assert (stats[:, 1].cpu() == want[1].max(dim=1).values).all()
    assert (stats[:, 0].cpu() >= 1).all()
    # through the op, as the heads call it
    op = mst.grid_mst(wr.to(cuda), wd.to(cuda), md)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(op, want))


def test_mst_kernel_on_negative_weights_and_signed_zeros(cuda):
    from boxinstseg_tpu_torch.ops import mst
    rng = np.random.RandomState(3)
    wr = np.round(rng.randn(3, 13, 16) * 1.5).astype(np.float32)
    wd = np.round(rng.randn(3, 12, 17) * 1.5).astype(np.float32)
    wr[(wr == 0) & (rng.rand(*wr.shape) < 0.5)] = -0.0
    wd[(wd == 0) & (rng.rand(*wd.shape) < 0.5)] = -0.0
    wr[0, 0, :3] = np.nan
    wr, wd = torch.from_numpy(wr), torch.from_numpy(wd)
    want = mst.grid_mst_plain(wr, wd, 13 * 17)
    got = mst.grid_mst_cuda(wr.to(cuda), wd.to(cuda), 13 * 17)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_mst_wrapper_rejects_what_it_does_not_take(cuda):
    from boxinstseg_tpu_torch.ops import mst
    side = int(mst.MAX_NODES ** 0.5) + 1           # one node too many a side
    for wr, wd in (
            (torch.zeros(2, 5, 4, device=cuda),
             torch.zeros(2, 4, 4, device=cuda)),              # w_down shape
            (torch.zeros(2, 5, 4, device=cuda, dtype=torch.float64),
             torch.zeros(2, 4, 5, device=cuda, dtype=torch.float64)),
            (torch.zeros(2, 4, 5, device=cuda).transpose(1, 2),
             torch.zeros(2, 4, 5, device=cuda)),
            (torch.zeros(1, side, side - 1, device=cuda),
             torch.zeros(1, side - 1, side, device=cuda))):
        with pytest.raises(ValueError):
            mst.grid_mst_cuda(wr, wd, 10)
    with pytest.raises(ValueError, match=f'at most {mst.MAX_NODES} nodes'):
        mst.grid_mst_cuda(torch.zeros(1, 129, 129, device=cuda),
                          torch.zeros(1, 128, 130, device=cuda), 10)


def test_host_syncs_are_counted_by_their_call_site(cuda):
    """Each synchronizing call that CUDA's sync debug mode reports inside
    ``utils.profiling.record(syncs=True)`` is one ``host_sync``, under the
    open span and by the port's frame that made it; the mode comes back on
    exit."""
    from boxinstseg_tpu_torch.apis.test import _host
    from boxinstseg_tpu_torch.utils.profiling import record, span
    x = torch.arange(8.0, device=cuda)
    mode = torch.cuda.get_sync_debug_mode()
    with record(syncs=True) as rec:
        with span('copy'):
            _host(x * 2)
            _host(x + 1)
    assert torch.cuda.get_sync_debug_mode() == mode
    assert rec.syncs_watched
    assert rec.counts['host_sync'] == rec.spans[0].counts['host_sync'] >= 2
    (site, n), = rec.sync_sites.items()
    assert site.startswith('boxinstseg_tpu_torch/apis/test.py:') and n >= 2
