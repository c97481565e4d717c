"""The MSDA and Swin window-attention kernels as registered torch ops, on
the CPU (their plain implementations; the card's are the kernels, held to
the same plain versions by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``).

- ``torch.library.opcheck`` (schema, autograd registration, the fake
  implementation against the real one, AOT dispatch with dynamic shapes)
  on ``boxinstseg::msda_forward``, ``msda_backward``, ``window_attention``
  and ``window_attention_backward`` at small shapes;
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

from boxinstseg_tpu_torch.ops import msda
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


@pytest.mark.parametrize('op', ['msda_forward', 'msda_backward',
                                'window_attention',
                                'window_attention_backward'])
def test_opcheck(op):
    if op.startswith('msda'):
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
