"""The hand-written kernels as registered torch ops, on the CPU (their
plain implementations; the card's are the kernels, held to the same plain
versions by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``): MSDA and
Swin window attention, and the loss path's BoxInst pairwise pair (K1/K2),
LCM (K3), CRF (K7), LSA and the grid MST.

- ``torch.library.opcheck`` (schema, autograd registration, the fake
  implementation against the real one, AOT dispatch with dynamic shapes)
  on ``boxinstseg::msda_forward``, ``msda_backward``, ``window_attention``,
  ``window_attention_backward``, ``pairwise_forward``,
  ``pairwise_backward``, ``lcm_forward``, ``lcm_adjoint``,
  ``crf_mean_field``, ``solve_lsa`` and ``grid_mst`` at small shapes;
- ``boxinst_pairwise_loss`` and ``lcm_refine`` against autograd through
  their plain versions, value and gradient within atol 1e-6;
  ``crf_mean_field``, ``solve_lsa`` and ``grid_mst`` element for element
  against theirs; each loss-path op has a CUDA and a CPU implementation;
  the pairwise op's denominator is this process's (no collective in the
  op);
- their flop formulas against a hand count (pairwise 90 and 120
  operations a (pixel, instance) at 8 offsets, LCM 2 a pixel, offset and
  round, CRF 18 a pixel and round), and no formula for the LSA;
- their fakes' output shapes under ``FakeTensorMode``;
- ``ms_deform_attn`` and ``window_attention_qkv`` (the callers' entries,
  now through the ops) against autograd through the plain versions:
  forward and every gradient within atol 1e-6 (the same arithmetic; the
  MSDA op's CPU backward is the explicit per-level backward);
- bf16 inputs run in fp32 and come back in bf16, gradients in their
  inputs' dtypes;
- the flop formulas under ``FlopCounterMode`` against a hand count: MSDA
  8 x D operations a sample forward and 16 x D backward, window attention
  4 N^2 C a window forward and 8 N^2 C backward;
- the fake implementations give the output shapes under ``FakeTensorMode``;
- the callers' checks still raise (reference points with a gradient, a
  device without an implementation).
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu_torch.ops import crf, lcm, lsa, msda, mst
from boxinstseg_tpu_torch.ops import pairwise as pw
from boxinstseg_tpu_torch.ops import swin_attention as swa

ATOL = 1e-6
LEVELS = ((5, 6), (3, 2))


def msda_inputs(seed, b=2, heads=2, d=4, p=3, levels=LEVELS, l=7):
    rng = np.random.RandomState(seed)
    s = sum(h * w for h, w in levels)
    t = [torch.from_numpy(x.astype(np.float32)) for x in (
        rng.randn(b, s, heads, d), rng.rand(b, l, 2),
        rng.randn(b, l, heads, len(levels), p, 2) * 2,
        rng.dirichlet(np.ones(len(levels) * p), (b, l, heads)).reshape(
            b, l, heads, len(levels), p),
        rng.randn(b, l, heads * d))]
    return t                       # value, ref, offsets, attn, grad_out


def swin_inputs(seed, images=2, hp=8, wp=8, ws=4, shift=2, heads=2, d=4):
    rng = np.random.RandomState(seed)
    n = ws * ws
    bw = images * (hp // ws) * (wp // ws)
    regions = torch.from_numpy(swa.shift_regions(hp, wp, ws, shift))
    qkv, bias, g = (torch.from_numpy(x.astype(np.float32)) for x in (
        rng.randn(bw, n, 3 * heads * d), rng.randn(heads, n, n),
        rng.randn(bw, n, heads * d)))
    return qkv, bias, regions.contiguous(), g


def flat(levels):
    return [n for sh in levels for n in sh]


def pairwise_inputs(seed, b=2, k=3, h=13, w=37):
    """logits, colour similarity, box bitmasks and validity; one sample
    invalid."""
    rng = np.random.RandomState(seed)
    valid = torch.from_numpy(rng.rand(b, k) > 0.2)
    valid[0, -1] = False
    bm = np.zeros((b, k, h, w), np.float32)
    bm[:, :, 2:h - 3, 4:w - 9] = 1
    bm[:, 1] = rng.rand(h, w) > 0.5
    return (torch.from_numpy((rng.randn(b, k, h, w) * 2).astype(np.float32)),
            torch.from_numpy(rng.rand(b, 8, h, w).astype(np.float32)),
            torch.from_numpy(bm), valid)


LCM_OFFSETS = [(dy, dx) for dy in (-2, 0, 2) for dx in (-2, 0, 2)
               if dy or dx]


def lcm_inputs(seed, b=2, c=3, h=9, w=11):
    rng = np.random.RandomState(seed)
    aff = rng.rand(b, len(LCM_OFFSETS), h, w).astype(np.float32)
    aff /= aff.sum(1, keepdims=True)
    return (torch.from_numpy(aff),
            torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)),
            torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)))


def crf_inputs(seed, b=2, k=5, h=12, w=20):
    rng = np.random.RandomState(seed)
    kern = torch.from_numpy(rng.rand(b, 9, h, w).astype(np.float32))
    targets = np.zeros((b, k, h, w), np.float32)
    targets[:, :, 1:h - 2, 2:w - 3] = 1
    bin0 = (rng.rand(b, k, h, w) > 0.5).astype(np.float32) * targets
    return (kern, 0.5 * crf.kernel_sum(kern), torch.from_numpy(bin0),
            torch.from_numpy(targets))


def lsa_inputs(seed, p=3, n=4, m=6):
    rng = np.random.RandomState(seed)
    cost = rng.rand(p, n, m).astype(np.float32)
    cost[1] = np.round(cost[1] * 3)              # ties
    return (torch.from_numpy(cost),
            torch.tensor([n, n - 2, 0], dtype=torch.int32)[:p])


def mst_inputs(seed, b=2, h=5, w=6):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(np.round(rng.rand(b, h, w - 1) * 4).astype(
        np.float32)), torch.from_numpy(np.round(rng.rand(
            b, h - 1, w) * 4).astype(np.float32)))


def loss_op_args(op, seed=0):
    """(the op, its arguments) at small shapes."""
    if op.startswith('pairwise'):
        x, sim, bm, valid = pairwise_inputs(seed)
        if op == 'pairwise_forward':
            return pw.pairwise_forward_op, (x, sim, bm, valid, 0.3, 3, 2)
        _, live = pw.pairwise_forward_op(x, sim, bm, valid, 0.3, 3, 2)
        return pw.pairwise_backward_op, (x, sim, bm, valid,
                                         torch.full((1,), 0.25), live, 0.3,
                                         3, 2)
    if op.startswith('lcm'):
        aff, phi, g = lcm_inputs(seed)
        flat = [v for o in LCM_OFFSETS for v in o]
        return ((lcm.lcm_forward_op, (aff, phi, flat, 4))
                if op == 'lcm_forward' else
                (lcm.lcm_adjoint_op, (aff, g, flat, 4)))
    if op == 'crf_mean_field':
        return crf.crf_mean_field_op, (*crf_inputs(seed), 5, 3)
    if op == 'solve_lsa':
        return lsa.solve_lsa_op, lsa_inputs(seed)
    assert op == 'grid_mst'
    return mst.grid_mst_op, (*mst_inputs(seed), 6)


LOSS_OPS = ['pairwise_forward', 'pairwise_backward', 'lcm_forward',
            'lcm_adjoint', 'crf_mean_field', 'solve_lsa', 'grid_mst']


@pytest.mark.parametrize('op', ['msda_forward', 'msda_backward',
                                'window_attention',
                                'window_attention_backward'] + LOSS_OPS)
def test_opcheck(op):
    if op in LOSS_OPS:
        target, args = loss_op_args(op)
    elif op.startswith('msda'):
        value, ref, offsets, attn, g = msda_inputs(0)
        args = (value, flat(LEVELS), ref, offsets, attn)
        target = msda.msda_forward
        if op == 'msda_backward':
            args, target = args + (g,), msda.msda_backward
    else:
        qkv, bias, regions, g = swin_inputs(0)
        args = (qkv, bias, regions, 0.5)
        target = swa.window_attention_op
        if op == 'window_attention_backward':
            args, target = args + (g,), swa.window_attention_backward_op
    assert target._qualname == f'boxinstseg::{op}'
    result = torch.library.opcheck(target, args)
    assert set(result.values()) == {'SUCCESS'}, result


def pairwise_case():
    x, sim, bm, valid = pairwise_inputs(1)
    got = x.clone().requires_grad_(True)
    want = x.clone().requires_grad_(True)
    out = pw.boxinst_pairwise_loss(got, sim, bm, valid)
    num, den = pw.pairwise_num_den_plain(want, sim, bm, valid)
    ref = num / den.clamp(min=1.0)
    # the op's den is this process's, the caller's reduction outside it
    num_den, live = pw.pairwise_forward_op(x, sim, bm, valid, 0.3, 3, 2)
    torch.testing.assert_close(num_den, torch.stack((num, den)).detach(),
                               atol=ATOL, rtol=0)
    assert live.dtype == torch.uint8 and 0 < live.sum() < live.numel()
    return out, ref, (got,), (want,), torch.ones(())


def lcm_case():
    aff, phi, g = lcm_inputs(2)
    got = phi.clone().requires_grad_(True)
    want = phi.clone().requires_grad_(True)
    out = lcm.lcm_refine(aff, got, LCM_OFFSETS, 4)
    ref = lcm.lcm_forward_plain(aff, want, LCM_OFFSETS, 4)
    return out, ref, (got,), (want,), g


@pytest.mark.parametrize('op', LOSS_OPS)
def test_loss_op_has_a_cuda_and_a_cpu_implementation(op):
    # the kernel on a CUDA tensor, the plain version on a CPU tensor
    name = f'boxinstseg::{op}'
    for key in ('CUDA', 'CPU'):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key), (
            name, key)


@pytest.mark.parametrize('caller', ['boxinst_pairwise_loss', 'lcm_refine',
                                    'crf_mean_field', 'solve_lsa',
                                    'grid_mst'])
def test_loss_path_callers_match_their_plain_versions(caller):
    if caller == 'crf_mean_field':
        args = crf_inputs(3)
        got = crf.crf_mean_field(*args, 5)
        want = crf.crf_mean_field_plain(*args, 5)
        assert torch.equal(got, want)
        assert not torch.equal(want, args[2])          # the rounds moved
        return
    if caller == 'grid_mst':
        w_right, w_down = mst_inputs(3)
        got = mst.grid_mst(w_right, w_down, 4)
        want = mst.grid_mst_plain(w_right, w_down, 4)
        assert all(g.dtype == torch.int64 for g in got)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert (want[1] == 4).any()                # the cap binds
        return
    if caller == 'solve_lsa':
        cost, n_rows = lsa_inputs(3)
        got = lsa.solve_lsa(cost, n_rows)
        assert got.dtype == torch.int64
        assert torch.equal(got, lsa.solve_lsa_plain(cost, n_rows))
        return
    out, ref, got, want, g = (pairwise_case() if caller ==
                              'boxinst_pairwise_loss' else lcm_case())
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    for a, b in zip(torch.autograd.grad(out, got, g),
                    torch.autograd.grad(ref, want, g)):
        assert b.abs().max() > 1e-3
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize('seed', [0, 1])
def test_msda_op_matches_autograd_through_plain(seed):
    value, ref, offsets, attn, g = msda_inputs(seed)
    got = [t.clone().requires_grad_(True) for t in (value, offsets, attn)]
    want = [t.clone().requires_grad_(True) for t in (value, offsets, attn)]
    out = msda.ms_deform_attn(got[0], LEVELS, ref, got[1], got[2])
    ref_out = msda.ms_deform_attn_plain(
        want[0], LEVELS, ref, want[1], want[2],
        sample=msda.msda_forward_plain)
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=0)
    grads = torch.autograd.grad(out, got, g)
    ref_grads = torch.autograd.grad(ref_out, want, g)
    for name, a, b in zip(('value', 'offsets', 'attn'), grads, ref_grads):
        assert b.abs().max() > 0.1, name
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0, msg=name)
    # the explicit backward alone, as the op's CPU implementation
    for a, b in zip(msda.ms_deform_attn_backward_plain(
            value, LEVELS, ref, offsets, attn, g), ref_grads):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize('shift', [0, 2])
def test_window_attention_op_matches_autograd_through_plain(shift):
    qkv, bias, regions, g = swin_inputs(3, shift=shift)
    got = [qkv.clone().requires_grad_(True), bias.clone().requires_grad_(True)]
    want = [qkv.clone().requires_grad_(True),
            bias.clone().requires_grad_(True)]
    out = swa.window_attention_qkv(got[0], got[1], regions, 0.5)
    c = qkv.shape[-1] // 3
    ref_out = swa.window_attention_plain(
        want[0][..., :c], want[0][..., c:2 * c], want[0][..., 2 * c:],
        want[1], regions, 0.5)
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=0)
    (out * g).sum().backward()
    (ref_out * g).sum().backward()
    for a, b in zip(got, want):
        assert b.grad.abs().max() > 0.1
        torch.testing.assert_close(a.grad, b.grad, atol=ATOL, rtol=0)


def test_bf16_inputs_run_in_fp32_and_keep_their_dtypes():
    value, ref, offsets, attn, _ = msda_inputs(4)
    leaves = [t.bfloat16().requires_grad_(True) for t in (value, offsets,
                                                          attn)]
    out = msda.ms_deform_attn(leaves[0], LEVELS, ref, leaves[1], leaves[2])
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert [t.grad.dtype for t in leaves] == [torch.bfloat16] * 3
    want = msda.ms_deform_attn_plain(*(t.detach().float() for t in (
        leaves[0],)), LEVELS, ref, leaves[1].detach().float(),
        leaves[2].detach().float())
    torch.testing.assert_close(out, want.bfloat16())

    qkv, bias, regions, _ = swin_inputs(4)
    q16 = qkv.bfloat16().requires_grad_(True)
    out = swa.window_attention_qkv(q16, bias, regions, 0.5)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert q16.grad.dtype == torch.bfloat16


def test_flop_formulas_match_a_hand_count():
    value, ref, offsets, attn, g = msda_inputs(5)
    b, s, heads, d = value.shape
    samples = attn.numel()             # (b, l, heads, levels, points)
    v = value.clone().requires_grad_(True)
    with FlopCounterMode(display=False) as counter:
        msda.ms_deform_attn(v, LEVELS, ref, offsets, attn).backward(g)
    counts = {str(k): n for k, n in
              counter.get_flop_counts()['Global'].items()}
    assert counts == {'boxinstseg.msda_forward': 8 * d * samples,
                      'boxinstseg.msda_backward': 16 * d * samples}

    qkv, bias, regions, g = swin_inputs(5)
    bw, n, c3 = qkv.shape
    q = qkv.clone().requires_grad_(True)
    with FlopCounterMode(display=False) as counter:
        swa.window_attention_qkv(q, bias, regions, 0.5).backward(g)
    counts = {str(k): n for k, n in
              counter.get_flop_counts()['Global'].items()}
    c = c3 // 3
    assert counts == {'boxinstseg.window_attention': 4 * bw * n * n * c,
                      'boxinstseg.window_attention_backward':
                          8 * bw * n * n * c}
    assert (bw, n, c) == (8, 16, 8)              # 4 windows of 16 an image


def test_fake_implementations_give_the_output_shapes():
    value, ref, offsets, attn, g = msda_inputs(6)
    qkv, bias, regions, gw = swin_inputs(6)
    with FakeTensorMode() as mode:
        fv, fr, fo, fa, fg = (mode.from_tensor(t) for t in (
            value, ref, offsets, attn, g))
        out = msda.msda_forward(fv, flat(LEVELS), fr, fo, fa)
        grads = msda.msda_backward(fv, flat(LEVELS), fr, fo, fa, fg)
        fq, fb, frg, fgw = (mode.from_tensor(t) for t in (qkv, bias,
                                                          regions, gw))
        att = swa.window_attention_op(fq, fb, frg, 0.5)
        dqkv, dbias = swa.window_attention_backward_op(fq, fb, frg, 0.5, fgw)
    assert tuple(out.shape) == tuple(g.shape)
    assert [tuple(t.shape) for t in grads] == [
        tuple(t.shape) for t in (value, offsets, attn)]
    assert tuple(att.shape) == tuple(gw.shape)
    assert (tuple(dqkv.shape), tuple(dbias.shape)) == (tuple(qkv.shape),
                                                       tuple(bias.shape))


def test_callers_still_refuse_what_the_ops_do_not_take():
    value, ref, offsets, attn, _ = msda_inputs(7)
    with pytest.raises(ValueError, match='must not require grad'):
        msda.ms_deform_attn(value, LEVELS, ref.requires_grad_(True),
                            offsets, attn)
    with pytest.raises(ValueError, match='do not tile'):
        msda.ms_deform_attn(value, ((5, 6), (3, 3)), ref.detach(), offsets,
                            attn)
    with pytest.raises(ValueError, match='no MSDA sampler'):
        msda.ms_deform_attn(*(t.to('meta') for t in (value,)), LEVELS,
                            ref.detach().to('meta'), offsets.to('meta'),
                            attn.to('meta'))
    qkv, bias, regions, _ = swin_inputs(7)
    with pytest.raises(ValueError, match='no window attention'):
        swa.window_attention_qkv(qkv.to('meta'), bias.to('meta'),
                                 regions.to('meta'), 0.5)
    with pytest.raises(ValueError, match='int32'):
        swa.window_attention_qkv(qkv, bias, regions.long(), 0.5)


@pytest.mark.parametrize('op', ['pairwise', 'lcm', 'crf', 'solve_lsa'])
def test_loss_path_flop_formulas_match_a_hand_count(op):
    with FlopCounterMode(display=False) as counter:
        if op == 'pairwise':
            x, sim, bm, valid = pairwise_inputs(4)
            pw.boxinst_pairwise_loss(x.requires_grad_(True), sim, bm,
                                     valid).backward()
            b, k, h, w = x.shape
            want = {'boxinstseg.pairwise_forward': 90 * b * k * h * w,
                    'boxinstseg.pairwise_backward': 120 * b * k * h * w}
        elif op == 'lcm':
            aff, phi, g = lcm_inputs(4)
            lcm.lcm_refine(aff, phi.requires_grad_(True), LCM_OFFSETS,
                           4).backward(g)
            n = 2 * len(LCM_OFFSETS) * phi.numel() * 4
            want = {'boxinstseg.lcm_forward': n, 'boxinstseg.lcm_adjoint': n}
        elif op == 'crf':
            args = crf_inputs(4)
            crf.crf_mean_field(*args, 5)
            want = {'boxinstseg.crf_mean_field': 2 * 9 * args[2].numel() * 5}
        else:
            lsa.solve_lsa(*lsa_inputs(4))
            want = {}                 # the work depends on the costs
    counts = {str(k): n for k, n in
              counter.get_flop_counts().get('Global', {}).items()}
    assert counts == want


@pytest.mark.parametrize('op', LOSS_OPS)
def test_loss_path_fakes_give_the_output_shapes(op):
    target, args = loss_op_args(op, seed=5)
    want = target(*args)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        got = target(*fake)
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    assert [(tuple(t.shape), t.dtype) for t in got] == [
        (tuple(t.shape), t.dtype) for t in want]


def test_loss_path_callers_still_refuse_what_the_ops_do_not_take():
    x, sim, bm, valid = pairwise_inputs(6)
    with pytest.raises(ValueError, match='no pairwise loss'):
        pw.boxinst_pairwise_loss(x.to('meta'), sim.to('meta'),
                                 bm.to('meta'), valid.to('meta'))
    with pytest.raises(ValueError, match='color_sim'):
        pw.boxinst_pairwise_loss(x, sim[:, :3], bm, valid)
    aff, phi, _ = lcm_inputs(6)
    with pytest.raises(ValueError, match='no LCM refinement'):
        lcm.lcm_refine(aff.to('meta'), phi.to('meta'), LCM_OFFSETS, 2)
    with pytest.raises(ValueError, match='aff'):
        lcm.lcm_refine(aff[:, :4], phi, LCM_OFFSETS, 2)
    args = crf_inputs(6)
    with pytest.raises(ValueError, match='3x3'):
        crf.crf_mean_field(*args, 5, kernel_size=5)
    with pytest.raises(ValueError, match='no CRF fixed point'):
        crf.crf_mean_field(*(a.to('meta') for a in args), 5)
    cost, n_rows = lsa_inputs(6)
    with pytest.raises(AssertionError):
        lsa.solve_lsa(cost.transpose(1, 2), n_rows)
    with pytest.raises(ValueError, match='no LSA solver'):
        lsa.solve_lsa(cost.to('meta'), n_rows.to('meta'))
