"""The arithmetic of the pairwise kernels K1 / K2 (``csrc/pairwise.cu``),
written out in PyTorch on the CPU and held to the plain version: the gates
packed as one bit an offset (the opposite of offset o is bit G-1-o), K1's
one evaluation an unordered pair with ``den`` counted apart as bitmask x
the gates that pass, K2's forward pair probabilities gathered G a pixel,
and the (instance, tile) liveness plan (``pairwise.live_tiles``) against
brute force. The inputs are box bitmasks: a box inside one tile, a frame
touching every border, an empty instance, an invalid one, the whole plane
and a box across tiles. Tolerances as the kernels' own: value rtol 1e-5,
unnormalised gradient atol 1e-6 / rtol 1e-5, den exact. The kernels
themselves run in ``tests/test_torch_cuda.py`` on the card, on the same
inputs; ``tests/test_torch_pairwise.py`` holds these to the JAX package.
No JAX here.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu_torch.ops import pairwise as pw
from boxinstseg_tpu_torch.ops.color import neighbor_offsets, shift2d

# (shape, kernel_size, dilation): ragged maps, W a multiple of 4 (16-byte
# rows) or not, the main path's stencil and the generic ones
BOX_SHAPES = [((2, 6, 37, 53), 3, 2), ((1, 6, 16, 64), 3, 2),
              ((2, 6, 21, 30), 3, 1), ((1, 6, 37, 53), 5, 1),
              ((2, 6, 40, 36), 5, 2)]


def box_inputs(shape, seed):
    """Logits (|x| up to ~16), blocky colour gates and six box instances
    an image: a box inside one 8x32 tile, a frame touching every border,
    an empty instance, an invalid one (with a box), the whole plane, a box
    across tiles (shifted in the second image)."""
    rng = np.random.RandomState(seed)
    b, k, h, w = shape
    logits = (rng.randn(b, k, h, w) * 4).astype(np.float32)
    coarse = rng.rand(b, 8, (h + 2) // 3, (w + 2) // 3)
    sim = np.repeat(np.repeat(coarse, 3, 2), 3, 3)[:, :, :h, :w]
    masks = np.zeros((b, k, h, w), np.float32)
    valid = np.ones((b, k), bool)
    for i in range(b):
        masks[i, 0, min(9, h - 1):min(14, h), min(35, w - 1):min(60, w)] = 1
        masks[i, 1, [0, h - 1], :] = 1
        masks[i, 1, :, [0, w - 1]] = 1
        masks[i, 3, 2:h - 3, 1:w // 2] = 1
        valid[i, 3] = False
        masks[i, 4] = 1
        y0, x0 = 3 + 2 * i, 5 + 3 * i
        masks[i, 5, y0:min(y0 + 19, h), x0:min(x0 + 40, w)] = 1
    return logits, sim.astype(np.float32), masks, valid


def gate_sim(sim, kernel_size):
    """(B, G, H, W) gates for a stencil of G offsets from 8 planes."""
    g = kernel_size * kernel_size - 1
    return torch.tensor(np.tile(sim, (1, -(-g // 8), 1, 1))[:, :g])


def gate_bits(color_sim, thresh):
    """(B, H, W) int64: bit o = [color_sim[:, o] >= thresh], as the fast
    kernels pack the gates in shared memory."""
    g = color_sim.shape[1]
    weights = (2 ** torch.arange(g, dtype=torch.int64))[None, :, None, None]
    return ((color_sim >= thresh).long() * weights).sum(1)


def _tensors(shape, kernel_size, seed):
    logits, sim, masks, valid = box_inputs(shape, seed)
    return (torch.tensor(logits), gate_sim(sim, kernel_size),
            torch.tensor(masks), torch.tensor(valid))


def _at(t, dy, dx):
    """t[..., p + (dy, dx)], zero outside (log-probs and weights)."""
    return shift2d(t, dy, dx)


def _inside(h, w, dy, dx):
    """(H, W) bool: whether p + (dy, dx) lies in the map."""
    ys = torch.arange(h)[:, None] + dy
    xs = torch.arange(w)[None, :] + dx
    return (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)


def pair_num_den(x, sim, bm, valid, thresh, kernel_size, dilation):
    """K1's sums: for the G/2 forward offsets f (second half of the
    row-major order) each pixel p takes the pair (p, p + o_f) once,
    weighted by w_f(p) + w_{G-1-f}(p + o_f); a pair whose earlier end is
    outside the map is taken at its later end; den is bitmask x valid x
    the number of gate bits set at p."""
    offs = neighbor_offsets(kernel_size, dilation)
    g = len(offs)
    h, w = x.shape[-2:]
    lf, lb = F.logsigmoid(x), F.logsigmoid(-x)
    wb = bm * valid.float()[..., None, None]
    bits = gate_bits(sim, thresh)[:, None]

    def weight(o, dy=0, dx=0):
        return _at(wb * ((bits >> o) & 1).float(), dy, dx)
    num = torch.zeros((), dtype=torch.float64)
    for f in range(g // 2, g):
        dy, dx = offs[f]
        wsum = weight(f) + weight(g - 1 - f, dy, dx)
        term = torch.logaddexp(lf + _at(lf, dy, dx), lb + _at(lb, dy, dx))
        num -= (wsum * term).double().sum()
        outside = ~_inside(h, w, -dy, -dx)
        num -= (weight(g - 1 - f) * torch.logaddexp(lf, lb)
                * outside).double().sum()
    popcount = sum(((bits >> o) & 1) for o in range(g))
    den = (wb * popcount.float()).double().sum()
    return num, den


def pair_grad(x, sim, bm, valid, thresh, kernel_size, dilation):
    """K2's gather: the forward pair probabilities pA_f(u) of pairs (u,
    u + o_f), then at p over d in order, (w_d(p) + w_{G-1-d}(p + o_d)) *
    (s(p) - pA), pA read at p for a forward d and at the neighbour p + o_d
    (its forward offset G-1-d) for a backward one."""
    offs = neighbor_offsets(kernel_size, dilation)
    g = len(offs)
    lf, lb = F.logsigmoid(x), F.logsigmoid(-x)
    s = torch.sigmoid(x)
    wb = bm * valid.float()[..., None, None]
    bits = gate_bits(sim, thresh)[:, None]
    p_a = {}
    for f in range(g // 2, g):
        dy, dx = offs[f]
        a = lf + _at(lf, dy, dx)
        p_a[f] = torch.exp(a - torch.logaddexp(a, lb + _at(lb, dy, dx)))
    acc = torch.zeros_like(x)
    for d, (dy, dx) in enumerate(offs):
        w_d = wb * ((bits >> d) & 1).float() + _at(
            wb * ((bits >> (g - 1 - d)) & 1).float(), dy, dx)
        pa = p_a[d] if d >= g // 2 else _at(p_a[g - 1 - d], dy, dx)
        if d < g // 2:
            # the anchor p + o_d may lie outside: its log-probs are 0 there
            a = lf + _at(lf, dy, dx)
            edge = torch.exp(a - torch.logaddexp(a, lb + _at(lb, dy, dx)))
            pa = torch.where(_inside(*x.shape[-2:], dy, dx), pa, edge)
        acc = acc + w_d * (s - pa)
    return acc


@pytest.mark.parametrize('kernel_size,dilation', [(3, 1), (3, 2), (5, 1),
                                                  (5, 2), (7, 1)])
def test_opposite_offset_is_bit_g_minus_1_minus_o(kernel_size, dilation):
    offs = neighbor_offsets(kernel_size, dilation)
    g = len(offs)
    assert g == kernel_size * kernel_size - 1
    for o, (dy, dx) in enumerate(offs):
        assert offs[g - 1 - o] == (-dy, -dx)
        forward = o >= g // 2
        assert forward == (dy > 0 or (dy == 0 and dx > 0))


@pytest.mark.parametrize('kernel_size', [3, 5])
def test_gate_bits_pack_one_bit_an_offset(kernel_size):
    _, sim, _, _ = _tensors((2, 6, 21, 30), kernel_size, 0)
    bits = gate_bits(sim, 0.3)
    for o in range(sim.shape[1]):
        assert torch.equal((bits >> o) & 1, (sim[:, o] >= 0.3).long())
    assert int(bits.max()) < 2 ** sim.shape[1]


@pytest.mark.parametrize('shape,kernel_size,dilation', BOX_SHAPES)
def test_pair_centric_sums_match_plain(shape, kernel_size, dilation):
    x, sim, bm, valid = _tensors(shape, kernel_size, 1)
    num, den = pair_num_den(x, sim, bm, valid, 0.3, kernel_size, dilation)
    want_num, want_den = pw.pairwise_num_den_plain(x, sim, bm, valid, 0.3,
                                                   kernel_size, dilation)
    assert num.item() == pytest.approx(want_num.item(), rel=1e-5)
    assert den.item() == want_den.item()


@pytest.mark.parametrize('shape,kernel_size,dilation', BOX_SHAPES)
def test_pair_gather_gradient_matches_plain(shape, kernel_size, dilation):
    x, sim, bm, valid = _tensors(shape, kernel_size, 2)
    got = pair_grad(x, sim, bm, valid, 0.3, kernel_size, dilation)
    want = pw.pairwise_grad_plain(x, sim, bm, valid, 0.3, kernel_size,
                                  dilation)
    assert want.abs().max().item() > 0.1
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    # the empty and the invalid instances get no gradient
    assert not got[:, 2:4].any()


def _brute_live(bm, valid, above, below, side, tile_h, tile_w):
    b, k, h, w = bm.shape
    ty, tx = -(-h // tile_h), -(-w // tile_w)
    out = torch.zeros((b, k, ty, tx), dtype=torch.bool)
    for i in range(b):
        for j in range(k):
            for y in range(ty):
                for x in range(tx):
                    y0, x0 = y * tile_h, x * tile_w
                    win = bm[i, j, max(y0 - above, 0):y0 + tile_h + below,
                             max(x0 - side, 0):x0 + tile_w + side]
                    out[i, j, y, x] = bool(valid[i, j]) and bool(win.any())
    return out


@pytest.mark.parametrize('tile_h', [8, 16])
@pytest.mark.parametrize('shape,kernel_size,dilation', BOX_SHAPES)
def test_live_tiles_match_brute_force(shape, kernel_size, dilation, tile_h):
    _, _, bm, valid = _tensors(shape, kernel_size, 3)
    r = kernel_size // 2 * dilation
    for above, below, side in ((0, r, r), (r, r, r), (0, 0, 0)):
        got = pw.live_tiles(bm, valid, above, below, side, tile_h)
        assert torch.equal(got, _brute_live(bm, valid, above, below, side,
                                            tile_h, 32))
    k2 = pw.live_tiles(bm, valid, r, r, r, tile_h)
    # the empty and the invalid instances are dead everywhere, the whole
    # plane live everywhere, the box inside one tile live in that tile
    assert not k2[:, 2:4].any()
    assert k2[:, 4].all()
    assert k2[:, 0, 9 // tile_h, min(35, shape[3] - 1) // 32].all()


def test_live_tiles_cover_every_weighted_pair():
    """A dead (instance, tile) item adds nothing: the plain sums over the
    live tiles' pixels alone (K2) or pairs anchored there (K1) equal the
    whole."""
    shape, kernel_size, dilation = (2, 6, 37, 53), 3, 2
    x, sim, bm, valid = _tensors(shape, kernel_size, 4)
    r = kernel_size // 2 * dilation
    live = pw.live_tiles(bm, valid, r, r, r)
    grad = pw.pairwise_grad_plain(x, sim, bm, valid, 0.3, kernel_size,
                                  dilation)
    pixels = live.repeat_interleave(8, 2).repeat_interleave(32, 3)
    pixels = pixels[..., :shape[2], :shape[3]]
    assert not grad[~pixels].any()
    assert grad[pixels].abs().max() > 0.1
