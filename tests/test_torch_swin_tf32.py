"""The arithmetic of the Swin window attention kernels K5/K6
(``csrc/swin_attention.cu``), emulated on the CPU.

The kernels run every product on the tensor cores in TF32 (``mma.sync
m16n8k8``), with each operand x split into hi = tf32(x) and lo = tf32(x -
hi) (``cvt.rna``) and a product summed as lo*hi + hi*lo + hi*hi in fp32,
eight k at a time. Here the same split products, in the same k steps,
give the forward and the backward in fp32; they are held against the plain
version in float64 to the tolerance that ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernels to (atol 1e-5 x max(1, max
|ref|), rtol 1e-4), with a margin of 10. A single TF32 product (hi*hi) falls
outside that tolerance: that is why the kernels split.

Only the rounding of the operands is modelled, not the tensor core's own
order of adding the eight products of a k step.
"""
import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu_torch.ops import swin_attention as swa

ATOL, RTOL = 1e-5, 1e-4        # KERNEL_ATOL / KERNEL_RTOL of chip_smoke.py
MARGIN = 10.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, rounding to nearest with
    ties away from zero (add half of the 13 dropped bits to the
    magnitude, then clear them)."""
    bits = x.contiguous().numpy().view(np.uint32)
    out = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000))
    return torch.from_numpy(out.view(np.float32))


def mm(a: torch.Tensor, b: torch.Tensor, split: bool,
       acc: torch.Tensor = None) -> torch.Tensor:
    """acc + a @ b in fp32 the kernels' way: k padded to steps of 8, each
    step adding lo*hi, hi*lo and hi*hi (split) or hi*hi alone."""
    k = a.shape[-1]
    pad = -k % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b.transpose(-1, -2), (0, pad)) \
        .transpose(-1, -2)
    shape = a.shape[:-1] + b.shape[-1:]
    acc = torch.zeros(shape) if acc is None else acc.expand(shape).clone()
    for k0 in range(0, k + pad, 8):
        ac, bc = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        ah, bh = tf32(ac), tf32(bc)
        if split:
            al, bl = tf32(ac - ah), tf32(bc - bh)
            acc = acc + al @ bh
            acc = acc + ah @ bl
        acc = acc + ah @ bh
    return acc


def emulate(q, k, v, bias, regions, scale, g, split):
    """(out, dq, dk, dv, dbias) in fp32 with the kernels' products, per
    (window, head) in the layout (BW, H, N, D). As in the kernels, the
    scores start from bias + mask and add the products of q * scale with
    k."""
    h = bias.shape[0]
    qh, kh, vh, gh = (swa._heads(t, h) for t in (q, k, v, g))
    r = regions[:, 0]
    mask = torch.where(r[:, :, None] != r[:, None, :], swa.NEG, 0.0)
    mask = mask[torch.arange(q.shape[0]) % r.shape[0]][:, None]
    s = mm(qh * scale, kh.transpose(-1, -2), split, bias[None] + mask)
    p = torch.softmax(s, -1)
    out = mm(p, vh, split)
    dp = mm(gh, vh.transpose(-1, -2), split)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = mm(ds, kh, split) * scale
    dk = mm(ds.transpose(-1, -2), qh, split) * scale
    dv = mm(p.transpose(-1, -2), gh, split)
    dbias = torch.zeros_like(bias)
    for w in range(ds.shape[0]):          # the windows in a fixed order
        dbias = dbias + ds[w]
    return (swa._merge_heads(out), swa._merge_heads(dq),
            swa._merge_heads(dk), swa._merge_heads(dv), dbias)


def reference(q, k, v, bias, regions, scale, g):
    args = [t.double() for t in (q, k, v, bias)]
    out = swa.window_attention_plain(*args, regions, scale)
    return (out, *swa.window_attention_backward_plain(*args, regions, scale,
                                                      g.double()))


def excess(got, want):
    """Largest error as a share of the kernels' tolerance."""
    tol = ATOL * max(want.abs().max().item(), 1.0) + RTOL * want.abs()
    return ((got.double() - want).abs() / tol).max().item()


def inputs(seed, hp, wp, ws, shift, heads, d, region_ids):
    rng = np.random.RandomState(seed)
    regions = swa.shift_regions(hp, wp, ws, shift)
    if region_ids:
        regions = rng.randint(0, region_ids, regions.shape).astype(np.int32)
    nw, _, n = regions.shape
    qkv, g = (rng.randn(nw, n, c).astype(np.float32)
              for c in (3 * heads * d, heads * d))
    bias = rng.randn(heads, n, n).astype(np.float32)
    qkv, bias, regions, g = (torch.from_numpy(a)
                             for a in (qkv, bias, regions, g))
    return (*swa._split(qkv), bias, regions, g)


# (hp, wp, window, shift, heads, head dim, random region ids): Swin-L's
# stage 2 at 1024x1024 (36 windows of 144 tokens, 24 heads, taken 6 heads
# at a time), a shifted Swin-T window-7 block, and a ragged small case
CASES = {'Swin-L stage 2': (72, 72, 12, 0, 24, 32, 0),
         'window 7': (14, 21, 7, 3, 6, 32, 0),
         'ragged': (8, 12, 4, 0, 2, 8, 3)}
NAMES = ('out', 'dq', 'dk', 'dv', 'dbias')


def _excesses(case, split):
    q, k, v, bias, regions, g = inputs(0, *case)
    heads, d = case[4], case[5]
    chunk = min(heads, 6)
    worst = dict.fromkeys(NAMES, 0.0)
    for h0 in range(0, heads, chunk):      # heads are independent
        cols = slice(h0 * d, (h0 + chunk) * d)
        part = (q[..., cols], k[..., cols], v[..., cols],
                bias[h0:h0 + chunk], regions, d ** -0.5, g[..., cols])
        for name, got, want in zip(NAMES, emulate(*part, split),
                                   reference(*part)):
            worst[name] = max(worst[name], excess(got, want))
    return worst


@pytest.mark.parametrize('case', list(CASES))
def test_split_products_hold_the_kernel_tolerance(case):
    worst = _excesses(CASES[case], split=True)
    assert all(e <= 1 / MARGIN for e in worst.values()), worst


@pytest.mark.parametrize('case', list(CASES))
def test_single_tf32_products_do_not(case):
    worst = _excesses(CASES[case], split=False)
    assert max(worst.values()) > 1.0, worst


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)              # TF32's unit at 1
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                      1 + 2.0 ** -11 - 2.0 ** -23, 1 + 3 * 2.0 ** -11,
                      0.1], dtype=torch.float32)
    got = tf32(x)
    assert got[0].item() == one + ulp          # a tie goes away from zero
    assert got[1].item() == -(one + ulp)
    assert got[2].item() == one                # below the tie goes down
    assert got[3].item() == one + 2 * ulp
    assert (got.numpy().view(np.uint32) & 0x1FFF == 0).all()
    assert abs(got[4].item() - 0.1) <= 0.1 * 2.0 ** -11
