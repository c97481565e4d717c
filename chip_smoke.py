#!/usr/bin/env python
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. device    - card name and power limit (nvidia-smi), torch / CUDA
               versions; TF32 off for matmuls and convolutions.
2. build     - compiles the hand-written kernels (csrc/*.cu), one nvcc per
               source, all started together.
3. kernels   - each kernel against its plain PyTorch version on the card, at
               the main path's shapes and at ragged ones: the pairwise pair
               (K1/K2), the MSDA pair (one launch a layer each way, at one
               Box2Mask encoder layer's full shapes and three ragged layer
               cases; the backward also against autograd through the plain
               forward, and whether two backward runs give the same bits),
               the LCM forward and adjoint (with the identity
               <A x, y> = <x, A^T y>); errors, times and each kernel's
               bound.
4. slice     - BoxInst R-50-FPN 1x at full width (random init from a seed)
               trained for 5 SGD steps through tools/train_torch.py on
               seeded synthetic 800x1333 images; the pairwise kernels'
               launch counts over that run must equal the step count.
5. reference - a small CondInst's loss dict on the card (kernels) against
               the same weights and batch on the CPU (plain versions).
6. box2mask  - Box2Mask R-50 LSJ at full width trained for 5 AdamW steps
               through tools/train_torch.py on seeded synthetic 1024x1024
               images; the MSDA and LCM kernels' launch counts over that run
               must equal their per-step counts (MSDA: one forward and one
               backward an encoder layer) times the step count. Each step's
               time is printed beside its live GT count.
7. box2mask reference - a small Box2Mask's loss dict on the card against the
               CPU.
8. swin kernels - the Swin window attention pair K5/K6 against its plain
               versions (alone, through its autograd.Function, and K6
               against autograd through the plain forward) at Swin-L's
               stage-0 (shifted) and stage-2 shapes, Swin-T's window 7 and a
               ragged small case; times at both Swin-L shapes beside the
               bound (at the fp32 rate, and with the products in 3xTF32 on
               the tensor cores) and beside torch's
               scaled_dot_product_attention as a yardstick. The kernels
               JSON rows carry stage 0; stage 2 rides beside it.
9. swin-l    - Box2Mask Swin-L LSJ at full width trained for 5 AdamW steps
               through tools/train_torch.py on seeded synthetic 1024x1024
               images, batch 1; then MaskFormer.predict on one image (K5
               only, no K6).
10. swin reference - a small Box2Mask on a tiny Swin (window 4, odd maps,
               shifted blocks): loss dict and backbone gradients on the card
               against the CPU.
11. crf kernel - the DiscoBox CRF fixed point K7 against its plain version,
               bit for bit, at the main path's shape (2, 128, 200, 336), its
               transpose and ragged shapes (odd maps, K = 1 and 5, three
               images, a plane without a target); time, bound, plain time.
12. discobox - DiscoBox R-50 3x at full width (the shipped config with
               ts_cfg.start_iter=2) trained for 5 SGD steps through
               tools/train_torch.py on seeded synthetic 800x1333 images,
               batch 2: K7 launches once a step, the teacher's forward runs
               in the steps after start_iter only, and the EMA replica
               equals the student up to start_iter and differs after; the
               median step time without and with the teacher apart.
13. discobox reference - a small DiscoBox with the correspondence loss and
               the gates forced open, two teacher-student steps on the card
               against the CPU: logs, the object bank and the parameters.

Prints a JSON line with one entry per kernel, the card's nvidia-smi line,
and as its last line {"ok": true, "device": {...}}.
"""
import contextlib
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs/boxinst/boxinst_r50_fpn_1x_coco.py')
B2M_CONFIG = os.path.join(ROOT,
                          'configs/box2mask/box2mask_r50_lsj_8x2_50e_coco.py')
SWIN_CONFIG = os.path.join(
    ROOT, 'configs/box2mask/box2mask_swin-l-p4-w12-384-lsj_8x1_50e_coco.py')
DISCO_CONFIG = os.path.join(
    ROOT, 'configs/discobox/discobox_solov2_coco_r50_fpn_3x.py')
STEPS = 5
MAIN_SHAPE = (2, 64, 200, 336)     # B, K=topk_per_img, 800/4, 1344/4
RAGGED_SHAPES = ((1, 3, 37, 53), (2, 5, 37, 53))
VALUE_RTOL = 1e-5                  # fp32, summation order
# on the unnormalised gradient d(num)/d(logits), whose entries are O(1);
# through autograd it is divided by max(den, 1), and so is GRAD_ATOL
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5
REF_RTOL, REF_ATOL = 1e-4, 1e-6    # cuDNN vs CPU conv summation order

# one encoder layer of Box2Mask's pixel decoder (R-50 and Swin-L LSJ):
# batch 2, 8 heads, 32 channels a head, 4 points, the levels at strides 32,
# 16, 8 of the 1024x1024 canvas in the decoder's order; L = S = 21,504
MSDA_B, MSDA_HEADS, MSDA_D, MSDA_P = 2, 8, 32, 4
MSDA_LEVELS = ((32, 32), (64, 64), (128, 128))
# layer cases (batch, heads, D, P, levels, queries, spread) on odd maps:
# the encoder's own queries (None) and random ones on the fast pair's D 32
# and P 4; D 48 and P 3 on two levels (the generic pair); samples spread up
# to `spread` map widths outside
MSDA_RAGGED = ((1, 3, 32, 4, ((13, 7), (7, 4), (4, 2)), None, 0),
               (1, 3, 32, 4, ((13, 7), (7, 4), (4, 2)), 37, 0.6),
               (2, 1, 48, 3, ((5, 11), (3, 6)), 19, 1.5))
LCM_MAIN = (2, 80, 96, 96)         # B, 10 outputs x 8 GT slots, tf_size
LCM_RAGGED = ((1, 3, 37, 53), (2, 5, 3, 5))
LCM_ITERS = 10
# MSDA and LCM kernels against their plain versions: atol is 1e-5 of the
# reference's largest entry (1e-5 at least), rtol 1e-4. fp32 sums in
# another order, and the MSDA d(value) with float atomics in an order that
# changes from run to run; d(loc) carries the map's width or height as a
# factor, so a fixed atol would not scale with it.
KERNEL_ATOL, KERNEL_RTOL = 1e-5, 1e-4
# Swin window attention (K5/K6) at (hp, wp, window, shift, images, heads,
# head dim, random region ids): Swin-L at 1024x1024, stage 0 (a shifted
# block, 484 windows of 144 tokens, 6 heads) and stage 2 (36 windows, 24
# heads); Swin-T's window 7; a ragged small case with three region ids. K5
# and K6 are held to KERNEL_ATOL / KERNEL_RTOL; dbias sums the windows in a
# fixed order (no atomics).
SWIN_MAIN = {'stage 0': (264, 264, 12, 6, 1, 6, 32, 0),
             'stage 2': (72, 72, 12, 0, 1, 24, 32, 0)}
SWIN_RAGGED = {'Swin-T window 7': (56, 56, 7, 3, 2, 3, 32, 0),
               'ragged': (8, 12, 4, 0, 2, 2, 8, 3)}
SWIN_REF_RTOL = 1e-3   # backbone gradients card vs CPU, relative L2 error
# K7 at DiscoBox's shape (batch 2, max_pos 128, the 800x1344 canvas at
# stride 4), its transpose, and ragged shapes; it must equal the plain
# version bit for bit (exact products summed in the same order)
CRF_MAIN = (2, 128, 200, 336)
CRF_SHAPES = ((2, 128, 336, 200), (1, 1, 37, 53), (1, 5, 37, 53),
              (3, 5, 37, 53))
CRF_ITERS = 10
DISCO_START_ITER = 2
ADJOINT_RTOL = 1e-5                # <A x, y> vs <x, A^T y>, float64 sums

# the least time of a kernel: bytes over the memory rate or operations over
# the fp32 rate (NVIDIA H100 SXM data sheet, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12            # dense tensor-core rate
# operations a kernel does per unit of work, counted from its source
# (a transcendental counts as one): per (pixel, instance) for the pairwise
# pair (two log-sigmoids, then per offset a pair log-prob, a logaddexp and
# the weighted sum; K2 adds the pair probability and the gradient terms),
# per kept sample for MSDA (four corners times a multiply-add per channel,
# plus the corner weights; the backward adds the row-dots), per pixel, round
# and offset for LCM (a multiply-add)
K1_OPS, K2_OPS = 90, 120

REPLACES = {
    'pairwise_forward': 'boxinstseg_tpu/ops/pallas_kernels.py:32',
    'pairwise_backward': 'boxinstseg_tpu/ops/pallas_kernels.py:119',
    'msda_forward': 'boxinstseg_tpu/ops/msda_pallas.py:274',
    'msda_backward': 'boxinstseg_tpu/ops/msda_pallas.py:397',
    'lcm_forward': 'boxinstseg_tpu/ops/pallas_kernels.py:380',
    'lcm_adjoint': 'boxinstseg_tpu/ops/pallas_kernels.py:380',
    'swin_attention_forward': 'boxinstseg_tpu/ops/swin_attention.py:93',
    'swin_attention_backward': 'boxinstseg_tpu/ops/swin_attention.py:116',
    'crf_mean_field': 'boxinstseg_tpu/ops/pallas_kernels.py:220',
}
SOURCES = {
    'pairwise_forward': 'boxinstseg_tpu_torch/csrc/pairwise.cu',
    'pairwise_backward': 'boxinstseg_tpu_torch/csrc/pairwise.cu',
    'msda_forward': 'boxinstseg_tpu_torch/csrc/msda.cu',
    'msda_backward': 'boxinstseg_tpu_torch/csrc/msda.cu',
    'lcm_forward': 'boxinstseg_tpu_torch/csrc/lcm.cu',
    'lcm_adjoint': 'boxinstseg_tpu_torch/csrc/lcm.cu',
    'swin_attention_forward': 'boxinstseg_tpu_torch/csrc/swin_attention.cu',
    'swin_attention_backward': 'boxinstseg_tpu_torch/csrc/swin_attention.cu',
    'crf_mean_field': 'boxinstseg_tpu_torch/csrc/crf.cu',
}


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


def phase(name):
    print(f'== {name}', flush=True)


def load_train_tool():
    spec = importlib.util.spec_from_file_location(
        'train_torch', os.path.join(ROOT, 'tools', 'train_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bound(nbytes, ops):
    """The least time (ms) for moving ``nbytes`` and doing ``ops`` fp32
    operations, and which of the two bounds it."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def bound_3xtf32(nbytes, product_ops, other_ops):
    """The least time (ms) of a kernel whose products run in 3xTF32 on the
    tensor cores (three TF32 products each) and its other operations at
    the fp32 rate, or of its bytes."""
    t_ops = 1e3 * (3 * product_ops / TF32_OPS_PER_S
                   + other_ops / FP32_OPS_PER_S)
    return max(1e3 * nbytes / HBM_BYTES_PER_S, t_ops)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class SyntheticBoxDataset:
    """Seeded stand-in for CocoDataset with the interface TrainLoader uses
    (``flag``, ``__len__``, ``prepare(idx, rng, scale)``).

    Each sample is a uint8 BGR image of ``img_h`` x ``img_w`` made of flat
    32x32 colour blocks with 1-8 solid-colour boxes on top (flat regions
    give the colour-similarity gates something to pass), sent through the
    config's train pipeline after the file-loading and resize steps, which
    the synthesis replaces (for BoxInst: RandomFlip, Normalize, Pad,
    DefaultFormatBundle and Collect; Box2Mask adds GenerateBoxMask,
    RandomCrop and FilterAnnotations). No cv2 is needed."""

    SKIP = ('LoadImageFromFile', 'LoadAnnotations', 'Resize')

    def __init__(self, pipeline, num_classes=80, length=16, img_h=800,
                 img_w=1333, **unused):
        from boxinstseg_tpu_torch.data.pipelines import Compose
        import numpy as np
        self.pipeline = Compose([t for t in pipeline
                                 if t['type'] not in self.SKIP])
        self.num_classes = num_classes
        self.length = length
        self.img_h, self.img_w = img_h, img_w
        self.flag = np.ones(length, np.uint8)     # all landscape

    def __len__(self):
        return self.length

    def prepare(self, idx, rng, scale=None):
        import numpy as np
        h, w = self.img_h, self.img_w
        blocks = rng.randint(0, 256, (h // 32 + 1, w // 32 + 1, 3))
        img = np.repeat(np.repeat(blocks, 32, 0), 32, 1)[:h, :w]
        img = np.ascontiguousarray(img, dtype=np.uint8)
        n = rng.randint(1, 9)
        boxes = np.zeros((n, 4), np.float32)
        for i in range(n):
            bw = rng.randint(32, min(400, w))
            bh = rng.randint(32, min(300, h))
            x1 = rng.randint(0, w - bw)
            y1 = rng.randint(0, h - bh)
            boxes[i] = (x1, y1, x1 + bw, y1 + bh)
            img[y1:y1 + bh, x1:x1 + bw] = rng.randint(0, 256, 3)
        results = dict(img=img, img_shape=img.shape, ori_shape=img.shape,
                       gt_bboxes=boxes,
                       gt_labels=rng.randint(0, self.num_classes, n),
                       bbox_fields=['gt_bboxes'], mask_fields=[], rng=rng)
        return self.pipeline(results)


def cuda_ms(fn, iters=20):
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(what, got, want):
    """Max abs error of a kernel's output against its plain version, within
    KERNEL_ATOL * max(1, max |want|) + KERNEL_RTOL * |want|; fails on a
    reference too small to make the check meaningful."""
    import torch
    ref = want.abs().max().item()
    if not ref > 0.1:
        fail(f'{what}: plain reference max {ref}: check is vacuous')
    diff = (got - want).abs()
    err = diff.max().item()
    tol = KERNEL_ATOL * max(ref, 1.0) + KERNEL_RTOL * want.abs()
    if not bool(torch.isfinite(got).all()) or not bool((diff <= tol).all()):
        fail(f'{what}: kernel differs from plain: max abs err {err} '
             f'(max |ref| {ref})')
    return err


def kernel_inputs(shape, gen):
    import torch
    b, k, h, w = shape
    x = torch.randn(shape, generator=gen, device='cuda') * 2
    sim = torch.rand((b, 8, h, w), generator=gen, device='cuda')
    bm = (torch.rand(shape, generator=gen, device='cuda') > 0.5).float()
    valid = torch.rand((b, k), generator=gen, device='cuda') > 0.2
    valid[0, -1] = False
    return x, sim, bm, valid


def phase_kernels():
    """K1/K2 against the plain version: through their autograd.Function,
    and K2 alone on the unnormalised gradient."""
    import torch
    from boxinstseg_tpu_torch.ops import pairwise as pw
    gen = torch.Generator(device='cuda').manual_seed(0)
    one = torch.ones(1, device='cuda')
    report = {}
    for shape in (MAIN_SHAPE,) + RAGGED_SHAPES:
        x, sim, bm, valid = kernel_inputs(shape, gen)
        xk = x.clone().requires_grad_(True)
        vk = pw.PairwiseLossFunction.apply(xk, sim, bm, valid, 0.3, 3, 2)
        vk.backward()
        xp = x.clone().requires_grad_(True)
        vp = pw.PlainPairwiseLossFunction.apply(xp, sim, bm, valid, 0.3, 3,
                                                2)
        vp.backward()
        g_kernel = pw.pairwise_grad_cuda(x, sim, bm, valid, one)
        g_plain = pw.pairwise_grad_plain(x, sim, bm, valid)
        _, den = pw.pairwise_num_den_plain(x, sim, bm, valid)
        torch.cuda.synchronize()
        inv_den = 1.0 / max(den.item(), 1.0)
        v_err = abs(vk.item() - vp.item())
        g_err = (g_kernel - g_plain).abs().max().item()
        g_max = g_plain.abs().max().item()
        print(f'{shape}: value kernel {vk.item():.9g} plain {vp.item():.9g}'
              f' abs err {v_err:.3g}; unnormalised grad max abs err '
              f'{g_err:.3g} (max |grad| {g_max:.3g}); through autograd '
              f'{(xk.grad - xp.grad).abs().max().item():.3g} (x 1/den '
              f'{inv_den:.3g})')
        if not math.isfinite(vk.item()) or v_err > VALUE_RTOL * abs(
                vp.item()):
            fail(f'K1 value {vk.item()} vs plain {vp.item()} at {shape}')
        if not g_max > 0.1:
            fail(f'plain gradient max {g_max} at {shape}: check is vacuous')
        if not torch.allclose(g_kernel, g_plain, atol=GRAD_ATOL,
                              rtol=GRAD_RTOL):
            fail(f'K2 gradient differs from plain at {shape}: {g_err}')
        if not torch.allclose(xk.grad, xp.grad, atol=GRAD_ATOL * inv_den,
                              rtol=GRAD_RTOL):
            fail(f'K2 through autograd differs from plain at {shape}')
        if shape == MAIN_SHAPE:
            scale = torch.full((1,), inv_den, device='cuda')
            pixels = x.numel()
            # K1 writes a (2, B, K, tiles) buffer of partial sums
            partials = 2 * x.numel() // (32 * 8) * 4
            report['pairwise_forward'] = dict(
                max_abs_err=v_err,
                ms=cuda_ms(lambda: pw.pairwise_forward_cuda(x, sim, bm,
                                                            valid)),
                plain_ms=cuda_ms(lambda: pw.pairwise_num_den_plain(
                    x, sim, bm, valid)),
                library_ms=None,
                **bound(nbytes(x, sim, bm, valid) + partials,
                        K1_OPS * pixels))
            report['pairwise_backward'] = dict(
                max_abs_err=g_err,
                ms=cuda_ms(lambda: pw.pairwise_grad_cuda(x, sim, bm, valid,
                                                         scale)),
                plain_ms=cuda_ms(lambda: pw.pairwise_grad_plain(
                    x, sim, bm, valid) * scale),
                library_ms=None,
                **bound(nbytes(x, sim, bm, valid, x), K2_OPS * pixels))
    for name, r in report.items():
        print(f'{name} at {MAIN_SHAPE}: kernel {r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms, bound {r["bound_ms"]:.4f} ms '
              f'({r["bound_by"]})')
    return report


def msda_layer_inputs(b, heads, d, p, levels, l, spread, gen):
    """One encoder layer's inputs to ``ms_deform_attn``. ``l`` None: the
    encoder's queries, one per position of every level with its reference
    point at the grid centre, sampling at the init bias (1-4 cells along
    each head's direction) plus unit noise, with the weights of a softmax
    over random logits. Else ``l`` random reference points whose samples
    spread up to ``spread`` map widths outside every level."""
    import torch
    from boxinstseg_tpu_torch.models.utils.transformer import \
        msda_offset_bias_init
    dev = 'cuda'
    nl = len(levels)
    s = sum(h * w for h, w in levels)
    size = torch.tensor([[w, h] for h, w in levels], device=dev,
                        dtype=torch.float32)[:, None]          # (nl, 1, 2)
    if l is None:
        refs = []
        for h, w in levels:
            ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
            xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
            refs.append(torch.stack(torch.meshgrid(xs, ys, indexing='xy'),
                                    -1).reshape(-1, 2))
        ref = torch.cat(refs)[None].expand(b, s, 2).contiguous()
        l = s
        bias = torch.from_numpy(msda_offset_bias_init(heads, nl, p)).to(dev)
        offsets = bias.reshape(heads, nl, p, 2) + torch.randn(
            (b, l, heads, nl, p, 2), generator=gen, device=dev)
    else:
        ref = torch.rand((b, l, 2), generator=gen, device=dev)
        loc = torch.rand((b, l, heads, nl, p, 2), generator=gen,
                         device=dev) * (1 + 2 * spread) - spread
        offsets = (loc - ref[:, :, None, None, None]) * size
    attn = torch.softmax(torch.randn((b, l, heads, nl * p), generator=gen,
                                     device=dev), -1)
    return (torch.randn((b, s, heads, d), generator=gen, device=dev), ref,
            offsets.contiguous(), attn.reshape(b, l, heads, nl, p),
            torch.randn((b, l, heads * d), generator=gen, device=dev))


def msda_kept(levels, ref, offsets):
    """The number of samples that count (``floor(x)`` in [-1, w-1] and
    ``floor(y)`` in [-1, h-1]), computed as the plain version does."""
    import torch
    kept = 0
    for lvl, (h, w) in enumerate(levels):
        lx = ref[:, :, None, None, 0] + offsets[:, :, :, lvl, :, 0] / w
        ly = ref[:, :, None, None, 1] + offsets[:, :, :, lvl, :, 1] / h
        x0 = torch.floor(lx * w - 0.5)
        y0 = torch.floor(ly * h - 0.5)
        kept += int(((x0 >= -1) & (x0 <= w - 1) & (y0 >= -1)
                     & (y0 <= h - 1)).sum().item())
    return kept


def check_msda(tag, levels, value, ref, offsets, attn, grad):
    """The MSDA kernel pair against ``ms_deform_attn``'s plain version: the
    forward, the backward against the plain backward and against autograd
    through the plain forward, both through ``MSDAFunction``; whether two
    backward runs give the same bits. Returns the forward and backward max
    abs errors and the largest difference between two backward runs."""
    import torch
    from boxinstseg_tpu_torch.ops import msda
    out_k = msda.msda_forward_cuda(value, levels, ref, offsets, attn)
    out_p = msda.ms_deform_attn_plain(value, levels, ref, offsets, attn)
    f_err = compare(f'MSDA forward {tag}', out_k, out_p)
    grads_k = msda.msda_backward_cuda(value, levels, ref, offsets, attn,
                                      grad)
    leaves = [t.clone().requires_grad_(True) for t in (value, offsets, attn)]
    grads_p = torch.autograd.grad(msda.ms_deform_attn_plain(
        leaves[0], levels, ref, leaves[1], leaves[2]), leaves, grad)
    grads_a = torch.autograd.grad(msda.ms_deform_attn_plain(
        leaves[0], levels, ref, leaves[1], leaves[2],
        sample=msda.msda_forward_plain), leaves, grad)
    b_err = 0.0
    names = ('d_value', 'd_offsets', 'd_attn')
    for name, gk, gp, ga in zip(names, grads_k, grads_p, grads_a):
        b_err = max(b_err, compare(f'MSDA backward {name} {tag}', gk, gp))
        compare(f'MSDA backward {name} {tag} vs autograd', gk, ga)
    out_f = msda.ms_deform_attn(leaves[0], levels, ref, leaves[1], leaves[2])
    grads_f = torch.autograd.grad(out_f, leaves, grad)
    compare(f'MSDAFunction forward {tag}', out_f.detach(), out_p)
    for name, gf, gp in zip(names, grads_f, grads_p):
        compare(f'MSDAFunction {name} {tag}', gf, gp)
    again = msda.msda_backward_cuda(value, levels, ref, offsets, attn, grad)
    same = [torch.equal(a, b) for a, b in zip(grads_k, again)]
    rerun = max((a - b).abs().max().item() for a, b in zip(grads_k, again))
    kept = msda_kept(levels, ref, offsets)
    print(f'MSDA {tag}: forward max abs err {f_err:.3g}, backward '
          f'{b_err:.3g} (max |d_offsets| '
          f'{grads_p[1].abs().max().item():.3g}); samples kept '
          f'{kept / attn.numel():.4f}; two backward runs bit-identical '
          f'{dict(zip(names, same))}, largest difference {rerun:.3g}')
    return f_err, b_err, rerun, kept


def phase_msda_kernels():
    """The MSDA kernel pair at one Box2Mask encoder layer's full shapes and
    at the ragged layer cases; times, plain times and bounds at the full
    shapes."""
    import torch
    from boxinstseg_tpu_torch.ops import msda
    gen = torch.Generator(device='cuda').manual_seed(1)
    value, ref, offsets, attn, grad = msda_layer_inputs(
        MSDA_B, MSDA_HEADS, MSDA_D, MSDA_P, MSDA_LEVELS, None, 0, gen)
    tag = (f'(B {MSDA_B}, heads {MSDA_HEADS}, D {MSDA_D}, P {MSDA_P}, '
           f'levels {MSDA_LEVELS}, L {ref.shape[1]})')
    f_err, b_err, rerun, kept = check_msda(tag, MSDA_LEVELS, value, ref,
                                           offsets, attn, grad)
    fwd_ms = cuda_ms(lambda: msda.msda_forward_cuda(value, MSDA_LEVELS, ref,
                                                    offsets, attn))
    bwd_ms = cuda_ms(lambda: msda.msda_backward_cuda(
        value, MSDA_LEVELS, ref, offsets, attn, grad))
    fwd_plain = cuda_ms(lambda: msda.ms_deform_attn_plain(
        value, MSDA_LEVELS, ref, offsets, attn), iters=5)
    leaves = [t.clone().requires_grad_(True) for t in (value, offsets, attn)]
    out_p = msda.ms_deform_attn_plain(leaves[0], MSDA_LEVELS, ref, leaves[1],
                                      leaves[2])
    bwd_plain = cuda_ms(lambda: torch.autograd.grad(
        out_p, leaves, grad, retain_graph=True), iters=5)
    # each input read once, each output written once; operations per kept
    # sample: four corners times a multiply-add per channel plus the corner
    # weights (the backward adds the row-dots and the location gradient)
    inputs = nbytes(value, ref, offsets, attn)
    fwd_bound = bound(inputs + nbytes(grad), kept * (8 * MSDA_D + 16))
    bwd_bound = bound(inputs + nbytes(grad) + nbytes(value, offsets, attn),
                      kept * (16 * MSDA_D + 30))
    # the corner rows the kernels gather through L1 / L2: four 4*D-byte
    # rows a kept sample
    gathered = kept * 4 * MSDA_D * 4
    for name, ms, plain, bnd in (('forward', fwd_ms, fwd_plain, fwd_bound),
                                 ('backward', bwd_ms, bwd_plain, bwd_bound)):
        print(f'MSDA {name} {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms,'
              f' bound {bnd["bound_ms"]:.4f} ms ({bnd["bound_by"]}), '
              f'{bnd["bound_ms"] / ms:.3f} of it; corner rows gathered '
              f'{gathered / 1e9:.3f} GB, {gathered / ms / 1e9:.3f} TB/s')
    report = {
        'msda_forward': dict(max_abs_err=f_err, ms=fwd_ms,
                             plain_ms=fwd_plain, library_ms=None,
                             **fwd_bound),
        'msda_backward': dict(max_abs_err=b_err, ms=bwd_ms,
                              plain_ms=bwd_plain, library_ms=None,
                              rerun_max_diff=rerun, **bwd_bound)}
    for b, heads, d, p, levels, l, spread in MSDA_RAGGED:
        check_msda(f'ragged (B {b}, heads {heads}, D {d}, P {p}, levels '
                   f'{levels}, L {l or "S"}, spread {spread})', levels,
                   *msda_layer_inputs(b, heads, d, p, levels, l, spread,
                                      gen))
    return report


def lcm_inputs(shape, gen):
    import torch
    from boxinstseg_tpu_torch.models.losses.levelset_loss import \
        LocalConsistencyModule
    b, c, h, w = shape
    module = LocalConsistencyModule(dilations=(2,), num_iter=LCM_ITERS)
    imgs = torch.rand((b, 3, h, w), generator=gen, device='cuda')
    aff = module.affinity(imgs).contiguous()
    phi = torch.rand(shape, generator=gen, device='cuda')
    g = torch.randn(shape, generator=gen, device='cuda')
    return module.offsets(), aff, phi, g


def check_lcm(shape, gen):
    """LCM forward and adjoint kernels against the plain rounds, the
    adjoint identity, and the backward of the autograd.Function."""
    import torch
    from boxinstseg_tpu_torch.ops import lcm
    offs, aff, phi, g = lcm_inputs(shape, gen)
    f_err = compare(f'LCM forward {shape}',
                    lcm.lcm_forward_cuda(aff, phi, offs, LCM_ITERS),
                    lcm.lcm_forward_plain(aff, phi, offs, LCM_ITERS))
    a_err = compare(f'LCM adjoint {shape}',
                    lcm.lcm_adjoint_cuda(aff, g, offs, LCM_ITERS),
                    lcm.lcm_adjoint_plain(aff, g, offs, LCM_ITERS))
    # <A x, y> = <x, A^T y>, positive x and y so that the sums do not cancel
    x, y = phi, torch.rand(shape, generator=gen, device='cuda')
    lhs = (lcm.lcm_forward_cuda(aff, x, offs, LCM_ITERS).double()
           * y.double()).sum().item()
    rhs = (x.double() * lcm.lcm_adjoint_cuda(aff, y, offs, LCM_ITERS)
           .double()).sum().item()
    if not abs(lhs - rhs) <= ADJOINT_RTOL * abs(lhs):
        fail(f'LCM adjoint identity at {shape}: <Ax, y> {lhs} vs '
             f'<x, A^T y> {rhs}')
    p = phi.clone().requires_grad_(True)
    lcm.lcm_refine(aff, p, offs, LCM_ITERS).backward(g)
    compare(f'LCM autograd backward {shape}', p.grad,
            lcm.lcm_adjoint_plain(aff, g, offs, LCM_ITERS))
    print(f'LCM {shape}: forward max abs err {f_err:.3g}, adjoint '
          f'{a_err:.3g}; <Ax, y> {lhs:.10g} vs <x, A^T y> {rhs:.10g}')
    return offs, aff, phi, g, f_err, a_err


def phase_lcm_kernels():
    import torch
    from boxinstseg_tpu_torch.ops import lcm
    gen = torch.Generator(device='cuda').manual_seed(2)
    offs, aff, phi, g, f_err, a_err = check_lcm(LCM_MAIN, gen)
    for shape in LCM_RAGGED:
        check_lcm(shape, gen)
    ops = LCM_ITERS * len(offs) * 2 * phi.numel()
    b = bound(nbytes(aff, phi, phi), ops)
    report = {
        'lcm_forward': dict(
            max_abs_err=f_err,
            ms=cuda_ms(lambda: lcm.lcm_forward_cuda(aff, phi, offs,
                                                    LCM_ITERS)),
            plain_ms=cuda_ms(lambda: lcm.lcm_forward_plain(
                aff, phi, offs, LCM_ITERS), iters=5),
            library_ms=None, **b),
        'lcm_adjoint': dict(
            max_abs_err=a_err,
            ms=cuda_ms(lambda: lcm.lcm_adjoint_cuda(aff, g, offs,
                                                    LCM_ITERS)),
            plain_ms=cuda_ms(lambda: lcm.lcm_adjoint_plain(
                aff, g, offs, LCM_ITERS), iters=5),
            library_ms=None, **b)}
    for name, r in report.items():
        print(f'{name} at {LCM_MAIN}: kernel {r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms, bound {r["bound_ms"]:.4f} ms '
              f'({r["bound_by"]})')
    return report


def swin_inputs(case, gen):
    """qkv (BW, N, 3C), bias (H, N, N), regions (nW, 1, N), g (BW, N, C) of
    one ``SWIN_MAIN`` / ``SWIN_RAGGED`` case, on the card."""
    import torch
    from boxinstseg_tpu_torch.ops.swin_attention import shift_regions
    hp, wp, ws, shift, images, heads, d, region_ids = case
    regions = torch.from_numpy(shift_regions(hp, wp, ws, shift)).cuda()
    if region_ids:
        regions = torch.randint(0, region_ids, regions.shape, generator=gen,
                                device='cuda', dtype=torch.int32)
    nw, _, n = regions.shape
    c = heads * d
    qkv = torch.randn((images * nw, n, 3 * c), generator=gen, device='cuda')
    bias = torch.randn((heads, n, n), generator=gen, device='cuda')
    g = torch.randn((images * nw, n, c), generator=gen, device='cuda')
    return qkv, bias, regions, g


def check_swin(tag, case, gen):
    """K5 and K6 against the plain versions: alone, through
    ``WindowAttentionFunction``, and K6 against autograd through the plain
    forward. Returns the inputs and the forward / backward max abs
    errors."""
    import torch
    from boxinstseg_tpu_torch.ops import swin_attention as swa
    qkv, bias, regions, g = swin_inputs(case, gen)
    scale = case[6] ** -0.5
    q, k, v = swa._split(qkv)
    out_p = swa.window_attention_plain(q, k, v, bias, regions, scale)
    f_err = compare(f'K5 {tag}', swa.window_attention_forward_cuda(
        q, k, v, bias, regions, scale), out_p)
    dqkv, dbias = swa.window_attention_backward_cuda(q, k, v, bias, regions,
                                                     scale, g)
    got = (*swa._split(dqkv), dbias)
    want = swa.window_attention_backward_plain(q, k, v, bias, regions, scale,
                                               g)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    auto = torch.autograd.grad(swa.window_attention_plain(
        *leaves[:3], leaves[3], regions, scale), leaves, g)
    b_err = 0.0
    for name, gk, gp, ga in zip(('dq', 'dk', 'dv', 'dbias'), got, want,
                                auto):
        b_err = max(b_err, compare(f'K6 {name} {tag}', gk, gp))
        compare(f'K6 {name} {tag} vs autograd', gk, ga)
    leaves = [t.clone().requires_grad_(True) for t in (qkv, bias)]
    out_f = swa.WindowAttentionFunction.apply(leaves[0], leaves[1], regions,
                                              scale)
    out_f.backward(g)
    compare(f'WindowAttentionFunction forward {tag}', out_f.detach(), out_p)
    compare(f'WindowAttentionFunction d(qkv) {tag}', leaves[0].grad,
            torch.cat(want[:3], -1))
    compare(f'WindowAttentionFunction d(bias) {tag}', leaves[1].grad,
            want[3])
    print(f'swin {tag} (BW {qkv.shape[0]}, N {qkv.shape[1]}, heads '
          f'{bias.shape[0]}, head dim {case[6]}, region ids '
          f'{int(regions.max().item()) + 1}): K5 max abs err {f_err:.3g}, '
          f'K6 {b_err:.3g} (max |dbias| {want[3].abs().max().item():.3g})')
    return (qkv, bias, regions, g, scale), f_err, b_err


def sdpa_backend(fn):
    """The kernels one call of ``fn`` ran, by the profiler, and the SDPA
    backend their names show."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type.name == 'CUDA'})
    joined = ' '.join(names).lower()
    for key, backend in (('flash', 'flash'), ('fmha', 'efficient'),
                         ('efficient', 'efficient'), ('cudnn', 'cudnn')):
        if key in joined:
            return backend, names
    return 'math', names


def phase_swin_kernels():
    """K5/K6 at the main path's shapes and ragged ones; times, bounds and
    the SDPA yardstick at Swin-L's stage-0 and stage-2 shapes."""
    import torch
    import torch.nn.functional as F
    from boxinstseg_tpu_torch.ops import swin_attention as swa
    gen = torch.Generator(device='cuda').manual_seed(3)
    report = {}
    for tag, case in SWIN_MAIN.items():
        (qkv, bias, regions, g, scale), f_err, b_err = check_swin(tag, case,
                                                                  gen)
        q, k, v = swa._split(qkv)
        bw, n = qkv.shape[:2]
        h, d = bias.shape[0], case[6]
        io = nbytes(qkv, bias, regions)
        # per (window, head): q k^T and P v (4 N^2 D), the logits' scale,
        # bias, mask, max, exponent and sum (6 N^2); the backward recomputes
        # the logits and softmax (2 N^2 D + 6 N^2), then dV, dP, dQ, dK
        # (8 N^2 D) and dS and the dbias sum (4 N^2)
        pairs = bw * h
        fwd_bytes = io + nbytes(g)
        bwd_bytes = io + nbytes(g) + nbytes(qkv, bias)
        fwd_bound = bound(fwd_bytes, pairs * (4 * n * n * d + 6 * n * n))
        bwd_bound = bound(bwd_bytes, pairs * (10 * n * n * d + 10 * n * n))
        fwd_bound['bound_3xtf32_ms'] = bound_3xtf32(
            fwd_bytes, pairs * 4 * n * n * d, pairs * 6 * n * n)
        bwd_bound['bound_3xtf32_ms'] = bound_3xtf32(
            bwd_bytes, pairs * 10 * n * n * d, pairs * 10 * n * n)
        fwd_ms = cuda_ms(lambda: swa.window_attention_forward_cuda(
            q, k, v, bias, regions, scale))
        bwd_ms = cuda_ms(lambda: swa.window_attention_backward_cuda(
            q, k, v, bias, regions, scale, g))
        fwd_plain = cuda_ms(lambda: swa.window_attention_plain(
            q, k, v, bias, regions, scale), iters=5)
        bwd_plain = cuda_ms(lambda: swa.window_attention_backward_plain(
            q, k, v, bias, regions, scale, g), iters=5)
        # the yardstick: one SDPA call on (BW, H, N, D) with the bias and
        # shift mask as a (BW, H, N, N) float mask built beforehand; its
        # backward with the mask requiring grad, the mask's gradient summed
        # over the windows being dbias
        heads = [swa._heads(t, h).contiguous() for t in (q, k, v)]
        r = regions[:, 0]
        mask = torch.where(r[:, :, None] != r[:, None, :], swa.NEG, 0.0)
        mask = (bias[None] + mask[torch.arange(bw, device='cuda')
                                  % r.shape[0]][:, None]).contiguous()
        gh = swa._heads(g, h).contiguous()
        lib_out = F.scaled_dot_product_attention(*heads, attn_mask=mask,
                                                 scale=scale)
        lib_err = (swa._merge_heads(lib_out) - swa.window_attention_plain(
            q, k, v, bias, regions, scale)).abs().max().item()
        leaves = [t.clone().requires_grad_(True) for t in heads + [mask]]

        def lib_fwd():
            return F.scaled_dot_product_attention(*heads, attn_mask=mask,
                                                  scale=scale)

        def lib_bwd():
            out = F.scaled_dot_product_attention(*leaves[:3],
                                                 attn_mask=leaves[3],
                                                 scale=scale)
            grads = torch.autograd.grad(out, leaves, gh)
            return grads[3].sum(0)

        backend_f, _ = sdpa_backend(lib_fwd)
        backend_b, names_b = sdpa_backend(lib_bwd)
        lib_fwd_ms = cuda_ms(lib_fwd)
        lib_bwd_ms = cuda_ms(lib_bwd)
        print(f'swin {tag}: K5 {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, '
              f'bound {fwd_bound["bound_ms"]:.4f} ms '
              f'({fwd_bound["bound_by"]}; 3xTF32 '
              f'{fwd_bound["bound_3xtf32_ms"]:.4f} ms), SDPA '
              f'{lib_fwd_ms:.4f} ms ({backend_f}; max abs diff to plain '
              f'{lib_err:.3g}); K6 {bwd_ms:.4f} ms, plain {bwd_plain:.4f} '
              f'ms, bound {bwd_bound["bound_ms"]:.4f} ms '
              f'({bwd_bound["bound_by"]}; 3xTF32 '
              f'{bwd_bound["bound_3xtf32_ms"]:.4f} ms), SDPA forward + '
              f'backward + window sum {lib_bwd_ms:.4f} ms ({backend_b}: '
              f'{", ".join(n[:60] for n in names_b[:4])})')
        rows = {'swin_attention_forward': dict(
                    max_abs_err=f_err, ms=fwd_ms, plain_ms=fwd_plain,
                    library_ms=lib_fwd_ms, **fwd_bound),
                'swin_attention_backward': dict(
                    max_abs_err=b_err, ms=bwd_ms, plain_ms=bwd_plain,
                    library_ms=lib_bwd_ms, **bwd_bound)}
        # the row's own numbers are stage 0's (comparable with earlier
        # runs); the other stages ride beside them under their tag
        for name, row in rows.items():
            if name in report:
                report[name][tag] = row
            else:
                report[name] = row
        del heads, mask, leaves, lib_out
    for tag, case in SWIN_RAGGED.items():
        check_swin(tag, case, gen)
    return report


def register_dataset():
    from boxinstseg_tpu_torch.registry import DATASETS
    if 'SyntheticBoxDataset' not in DATASETS:
        DATASETS.register_module(module=SyntheticBoxDataset)


def check_history(result, steps, required=()):
    if result.step != steps:
        fail(f'ran {result.step} steps, expected {steps}')
    for i, logs in enumerate(result.history):
        bad = [k for k, v in logs.items() if not math.isfinite(v)]
        if bad:
            fail(f'step {i}: non-finite {bad}')
        for k in required:
            if i > 0 and not logs[k] > 0:
                fail(f'step {i}: {k} {logs[k]}')


def changed_tensors(tool, cfg, seed, result):
    """The names of the tensors that training changed, and the model (on
    the CPU) with the trained weights loaded."""
    import torch
    model = tool.build_model(cfg, seed)
    init = model.state_dict()
    final = torch.load(result.checkpoint, map_location='cpu')
    if final['_iter'] != result.step:
        fail(f'checkpoint _iter {final["_iter"]}')
    changed = [k for k, v in final['state_dict'].items()
               if v.is_floating_point() and not torch.equal(v, init[k])]
    model.load_state_dict(final['state_dict'])
    return changed, model


@contextlib.contextmanager
def live_gt_counts():
    """Collect each training step's live GT count (the host batch's
    ``gt_valid``, read before it goes to the card: no device wait)."""
    from boxinstseg_tpu_torch.apis import train
    to_device = train.batch_to_device
    counts = []

    def counted(batch, device):
        counts.append(int(batch['gt_valid'].sum()))
        return to_device(batch, device)
    train.batch_to_device = counted
    try:
        yield counts
    finally:
        train.batch_to_device = to_device


def print_steps(result, peak, gts, teacher_after=None):
    """Each step's time beside its live GT count; the median of steps 2-5,
    or for DiscoBox (``teacher_after`` = start_iter) of the steps without
    and with the teacher's forward apart (PERF.md section 2)."""
    step_ms = [1e3 * (h['time'] - h['data_time']) for h in result.history]
    print(f'losses at step {result.step}: ' + ', '.join(
        f'{k} {v:.5f}' for k, v in result.history[-1].items()
        if k.startswith('loss')))
    print('step ms (compute + sync, data excluded) with live GTs: ' +
          ', '.join(f'{t:.3f} ({n} GTs)' for t, n in zip(step_ms, gts)))
    if teacher_after is None:
        medians = (f'median of steps 2-{result.step} '
                   f'{statistics.median(step_ms[1:]):.3f} ms')
    else:
        k = teacher_after + 1
        medians = (f'median of steps 2-{k} (no teacher) '
                   f'{statistics.median(step_ms[1:k]):.3f} ms, of steps '
                   f'{k + 1}-{result.step} (teacher) '
                   f'{statistics.median(step_ms[k:]):.3f} ms')
    print(f'{medians}; peak memory {peak / 2**30:.3f} GiB')


def phase_slice(tool):
    """5 SGD steps of BoxInst R-50-FPN 1x through the train entry point."""
    import torch
    from boxinstseg_tpu_torch.ops import pairwise as pw
    register_dataset()
    work_dir = tempfile.mkdtemp(prefix='chip_smoke_')
    seed = 0
    opts = ['model.mask_head.pairwise_warmup=1',
            'runner.type=IterBasedRunner', f'runner.max_iters={STEPS}',
            'data.samples_per_gpu=2', 'data.train.type=SyntheticBoxDataset']
    try:
        cfg = tool.load_config(CONFIG, opts, work_dir, seed)
        head = cfg.model.bbox_head
        gen_params = tool.build_model(cfg, seed).mask_head.num_gen_params
        print(f'model: {cfg.model.backbone.type}-{cfg.model.backbone.depth}'
              f', FPN {cfg.model.neck.out_channels}, '
              f'{head.stacked_convs}x GN towers, {gen_params} dynamic '
              f'params, {head.num_classes} classes, topk_per_img '
              f'{cfg.model.mask_head.topk_per_img}')
        torch.cuda.reset_peak_memory_stats()
        pw.pairwise_forward_cuda.launches = 0
        pw.pairwise_grad_cuda.launches = 0
        with live_gt_counts() as gts:
            result = tool.main([CONFIG, '--work-dir', work_dir, '--seed',
                                str(seed), '--device', 'cuda',
                                '--cfg-options', *opts])
        torch.cuda.synchronize()
        launches = {'pairwise_forward': pw.pairwise_forward_cuda.launches,
                    'pairwise_backward': pw.pairwise_grad_cuda.launches}
        peak = torch.cuda.max_memory_allocated()
        check_history(result, STEPS, required=('loss_pairwise',))
        for name, n in launches.items():
            if n != STEPS:
                fail(f'{name} launched {n} times in {STEPS} steps')
        changed, _ = changed_tensors(tool, cfg, seed, result)
        if not changed:
            fail('no parameter changed in training')
        print(f'{len(changed)} tensors changed; launches {launches}')
        print_steps(result, peak, gts)
        return launches
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def describe_backbone(bb):
    if bb.type == 'ResNet':
        return f'ResNet-{bb.depth}'
    return (f'{bb.type} embed {bb.embed_dims}, depths {list(bb.depths)}, '
            f'heads {list(bb.num_heads)}, window {bb.window_size}')


def phase_box2mask(tool, config, samples, parts):
    """5 AdamW steps of a Box2Mask config through the train entry point on
    1024x1024 synthetic images, ``samples`` a batch. Returns the launches of
    the kernels over the run, their expected per-step counts, the config
    and the trained model (on the CPU). Fails unless a tensor of each of
    ``parts`` changed."""
    import torch
    from boxinstseg_tpu_torch.ops import lcm, msda
    from boxinstseg_tpu_torch.ops import swin_attention as swa
    register_dataset()
    work_dir = tempfile.mkdtemp(prefix='chip_smoke_b2m_')
    seed = 0
    opts = ['runner.type=IterBasedRunner', f'runner.max_iters={STEPS}',
            f'data.samples_per_gpu={samples}',
            'data.train.type=SyntheticBoxDataset',
            'data.train.img_h=1024', 'data.train.img_w=1024']
    counters = {'msda_forward': msda.msda_forward_cuda,
                'msda_backward': msda.msda_backward_cuda,
                'lcm_forward': lcm.lcm_forward_cuda,
                'lcm_adjoint': lcm.lcm_adjoint_cuda}
    try:
        cfg = tool.load_config(config, opts, work_dir, seed)
        head = cfg.model.panoptic_head
        pd, td = head.pixel_decoder, head.transformer_decoder
        levels = head.num_transformer_feat_level
        bb = cfg.model.backbone
        print(f'model: {describe_backbone(bb)}, pixel decoder '
              f'{pd.num_encoder_layers} MSDeformAttn layers x {levels} '
              f'levels, {td.num_layers}-layer decoder, {head.num_queries} '
              f'queries, {head.feat_channels} channels, FFN '
              f'{td.transformerlayers.feedforward_channels}, '
              f'{head.num_things_classes} classes, canvas '
              f'{cfg.canvases[0]}, batch {samples}, optimizer '
              f'{cfg.optimizer.type}, grad clip '
              f'{cfg.optimizer_config.grad_clip.max_norm}')
        # one MSDA launch per encoder layer (all levels); one LCM
        # refinement; one K5 and one K6 per Swin block
        per_step = {'msda_forward': pd.num_encoder_layers,
                    'msda_backward': pd.num_encoder_layers,
                    'lcm_forward': 1, 'lcm_adjoint': 1}
        if bb.type == 'SwinTransformer':
            counters['swin_attention_forward'] = \
                swa.window_attention_forward_cuda
            counters['swin_attention_backward'] = \
                swa.window_attention_backward_cuda
            per_step['swin_attention_forward'] = sum(bb.depths)
            per_step['swin_attention_backward'] = sum(bb.depths)
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        with live_gt_counts() as gts:
            result = tool.main([config, '--work-dir', work_dir, '--seed',
                                str(seed), '--device', 'cuda',
                                '--cfg-options', *opts])
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        check_history(result, STEPS,
                      required=('loss_cls', 'loss_project',
                                'loss_levelset'))
        for name, n in launches.items():
            if n != per_step[name] * STEPS:
                fail(f'{name} launched {n} times in {STEPS} steps, expected '
                     f'{per_step[name]} a step')
        changed, model = changed_tensors(tool, cfg, seed, result)
        for part in parts:
            if not any(part in k for k in changed):
                fail(f'no *{part}* tensor changed in training')
        print(f'{len(changed)} tensors changed; launches {launches} '
              f'(per step {per_step})')
        print_steps(result, peak, gts)
        return launches, cfg, model
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def phase_swin_predict(cfg, model):
    """``MaskFormer.predict`` of the trained Swin-L on one 1024x1024 image:
    K5 once per block a call, K6 never; the instance candidates' shapes;
    the median wall time of 3 calls after 1 warm-up."""
    import torch
    from boxinstseg_tpu_torch.ops import swin_attention as swa
    fwd, bwd = (swa.window_attention_forward_cuda,
                swa.window_attention_backward_cuda)
    blocks = sum(cfg.model.backbone.depths)
    k = cfg.model.test_cfg.max_per_image
    model = model.cuda().eval()
    gen = torch.Generator().manual_seed(0)
    batch = {'image': torch.randn((1, 3, 1024, 1024), generator=gen).cuda()}
    fwd.launches = bwd.launches = 0
    out = model.predict(batch)
    torch.cuda.synchronize()
    if (fwd.launches, bwd.launches) != (blocks, 0):
        fail(f'predict launched K5 {fwd.launches} and K6 {bwd.launches} '
             f'times, expected {blocks} and 0')
    want = {'scores': (1, k), 'labels': (1, k), 'valid': (1, k),
            'masks_logit': (1, k, 256, 256)}
    for key, shape in want.items():
        if tuple(out[key].shape) != shape:
            fail(f'predict {key} {tuple(out[key].shape)}, expected {shape}')
    if not (torch.isfinite(out['scores']).all()
            and torch.isfinite(out['masks_logit']).all()):
        fail('predict gave non-finite scores or mask logits')
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.predict(batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    if (fwd.launches, bwd.launches) != (4 * blocks, 0):
        fail(f'4 predict calls launched K5 {fwd.launches} and K6 '
             f'{bwd.launches} times')
    print(f'predict: {k} candidates, scores {out["scores"][0, :3].tolist()}'
          f', labels {out["labels"][0, :3].tolist()}, masks_logit '
          f'{tuple(out["masks_logit"].shape)}; K5 {blocks} launches a call,'
          f' K6 none; wall ms {[round(t, 3) for t in times]}, median '
          f'{statistics.median(times):.3f} ms')


def tiny_cfg():
    return dict(
        type='CondInst',
        backbone=dict(type='ResNet', depth=18, frozen_stages=1),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, start_level=1,
                  add_extra_convs='on_output', num_outs=5,
                  relu_before_extra_convs=True),
        bbox_head=dict(type='CondInstBoxHead', num_classes=4,
                       in_channels=32, feat_channels=32, stacked_convs=1,
                       norm_cfg=dict(type='GN', num_groups=4)),
        mask_branch=dict(type='CondInstMaskBranch', in_channels=32,
                         branch_convs=1, branch_channels=16,
                         branch_out_channels=8),
        mask_head=dict(type='CondInstMaskHead', in_channels=8,
                       topk_per_img=8, pairwise_warmup=100))


def compare_loss_dicts(cfg, batch, iteration=None, grads_of=None):
    """The model's loss dict on the card against the CPU, same weights;
    with ``grads_of``, also the gradients of the total loss for the
    parameters whose names start with it (relative L2 error per tensor,
    SWIN_REF_RTOL of the larger of its norm and a thousandth of the
    largest norm: a bias before a GroupNorm has a gradient of rounding
    noise)."""
    import torch
    from boxinstseg_tpu_torch.registry import build_detector
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_detector(cfg).train()
    losses, grads = {}, {}
    for dev in ('cpu', 'cuda'):
        model.to(dev)
        model.zero_grad(set_to_none=True)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state = {k: v.clone() for k, v in model.state_dict().items()}
        args = () if iteration is None else (iteration,)
        with torch.set_grad_enabled(grads_of is not None):
            out = model.loss(tb, *args)
        losses[dev] = {k: v.item() for k, v in out.items()}
        if grads_of is not None:
            sum(v for k, v in out.items() if 'loss' in k).backward()
            grads[dev] = {k: p.grad.detach().cpu().clone()
                          for k, p in model.named_parameters()
                          if k.startswith(grads_of)}
        model.load_state_dict(state)      # undo the BN running-stat update
    if grads_of is not None:
        largest = max(g.norm().item() for g in grads['cpu'].values())
        worst = 0.0
        for k, want in grads['cpu'].items():
            err = (grads['cuda'][k] - want).norm().item()
            scale = max(want.norm().item(), 1e-3 * largest)
            worst = max(worst, err / scale)
            if not err <= SWIN_REF_RTOL * scale:
                fail(f'gradient of {k} on the card vs CPU: relative L2 '
                     f'error {err / scale:.3g}')
        print(f'{len(grads["cpu"])} {grads_of}* gradients: worst relative '
              f'L2 error card vs CPU {worst:.3g} (largest norm '
              f'{largest:.3g})')
    for k, want in losses['cpu'].items():
        got = losses['cuda'][k]
        print(f'{k}: cuda {got:.7g} cpu {want:.7g}')
        if not math.isfinite(got) or abs(got - want) > REF_ATOL \
                + REF_RTOL * abs(want):
            fail(f'{k} on the card {got} vs CPU {want}')
    return losses['cuda']


def phase_reference():
    """Small CondInst: loss dict on the card vs the CPU plain path."""
    import numpy as np
    rng = np.random.RandomState(0)
    b, h, w, g = 2, 128, 160, 5
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(rng.randint(1, g + 1)):
            x1, y1 = rng.randint(0, w - 40), rng.randint(0, h - 40)
            boxes[i, j] = (x1, y1, x1 + rng.randint(16, 40),
                           y1 + rng.randint(16, 40))
            valid[i, j] = True
    batch = dict(image=rng.rand(b, 3, h, w).astype(np.float32) * 4 - 2,
                 img_shape=np.array([[h, w]] * b, np.int32),
                 pixels_removed=np.array([5] * b, np.int32),
                 gt_bboxes=boxes, gt_labels=rng.randint(0, 4, (b, g)),
                 gt_valid=valid)
    compare_loss_dicts(tiny_cfg(), batch, 50)


def tiny_box2mask_cfg():
    """ResNet-18, 32 channels, 2 encoder and 3 decoder layers, 10 queries,
    a 24x24 tree filter with a binding depth cap."""
    return dict(
        type='Box2Mask',
        backbone=dict(type='ResNet', depth=18, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=-1),
        panoptic_head=dict(
            type='Box2MaskHead', in_channels=[64, 128, 256, 512],
            strides=[4, 8, 16, 32], feat_channels=32, out_channels=32,
            num_things_classes=4, num_stuff_classes=0, num_queries=10,
            num_transformer_feat_level=3,
            pixel_decoder=dict(num_outs=3, num_encoder_layers=2),
            transformer_decoder=dict(
                num_layers=3, transformerlayers=dict(
                    attn_cfgs=dict(num_heads=4), feedforward_channels=64)),
            loss_cls=dict(type='CrossEntropyLoss', loss_weight=2.0),
            loss_box=dict(type='BoxProjectionLoss', loss_weight=5.0),
            loss_mask=dict(type='LevelsetLoss', loss_weight=1.0),
            max_matched=4, tf_size=(24, 24), tf_max_depth=64),
        train_cfg=dict(assigner=dict(cls_cost=dict(weight=2.0),
                                     dice_cost=dict(weight=5.0))))


def phase_box2mask_reference():
    """Small Box2Mask: loss dict on the card (kernels) vs the CPU (plain
    versions)."""
    import numpy as np
    from boxinstseg_tpu_torch.ops import lcm, msda
    rng = np.random.RandomState(0)
    b, h, w, g = 2, 128, 128, 4
    masks = np.zeros((b, g, h // 4, w // 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(rng.randint(1, g + 1)):
            x1, y1 = rng.randint(0, w - 48), rng.randint(0, h - 48)
            x2, y2 = x1 + rng.randint(24, 48), y1 + rng.randint(24, 48)
            masks[i, j, y1 // 4:y2 // 4 + 1, x1 // 4:x2 // 4 + 1] = 1
            valid[i, j] = True
    batch = dict(image=rng.rand(b, 3, h, w).astype(np.float32) * 4 - 2,
                 gt_masks=masks, gt_labels=rng.randint(0, 4, (b, g)),
                 gt_valid=valid)
    before = msda.msda_forward_cuda.launches, lcm.lcm_forward_cuda.launches
    compare_loss_dicts(tiny_box2mask_cfg(), batch)
    if (msda.msda_forward_cuda.launches, lcm.lcm_forward_cuda.launches) \
            == before:
        fail('the small Box2Mask on the card launched no MSDA / LCM kernel')


def phase_swin_reference():
    """The small Box2Mask on a tiny Swin (window 4; 120x136 images give
    30x34, 15x17, 8x9 and 4x5 token maps, all padded, with shifted blocks in
    every stage): loss dict and backbone gradients on the card (K5, K6)
    against the CPU (plain versions)."""
    import numpy as np
    from boxinstseg_tpu_torch.ops import swin_attention as swa
    rng = np.random.RandomState(1)
    b, h, w, g = 2, 120, 136, 4
    masks = np.zeros((b, g, h // 4, w // 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(rng.randint(1, g + 1)):
            x1, y1 = rng.randint(0, w - 48), rng.randint(0, h - 48)
            x2, y2 = x1 + rng.randint(24, 48), y1 + rng.randint(24, 48)
            masks[i, j, y1 // 4:y2 // 4 + 1, x1 // 4:x2 // 4 + 1] = 1
            valid[i, j] = True
    batch = dict(image=rng.rand(b, 3, h, w).astype(np.float32) * 4 - 2,
                 gt_masks=masks, gt_labels=rng.randint(0, 4, (b, g)),
                 gt_valid=valid)
    cfg = tiny_box2mask_cfg()
    cfg['backbone'] = dict(type='SwinTransformer', embed_dims=32,
                           depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4),
                           window_size=4)
    cfg['panoptic_head']['in_channels'] = [32, 64, 128, 256]
    fwd, bwd = (swa.window_attention_forward_cuda,
                swa.window_attention_backward_cuda)
    fwd.launches = bwd.launches = 0
    compare_loss_dicts(cfg, batch, grads_of='backbone.')
    if (fwd.launches, bwd.launches) != (8, 8):
        fail(f'the small Swin Box2Mask on the card launched K5 '
             f'{fwd.launches} and K6 {bwd.launches} times, expected 8 each')


def crf_inputs(shape, gen, rng):
    """K7's inputs as DiscoBox makes them on the card: the CRF kernel of a
    blocky image (flat 8x8 blocks at stride 4, the synthetic data's 32x32,
    plus noise), its threshold, box targets and random scores inside them;
    with more than one plane an image, the last plane of image 0 has no
    target."""
    import torch
    from boxinstseg_tpu_torch.models.dense_heads.discobox_head import \
        MeanFieldCRF
    from boxinstseg_tpu_torch.ops import crf
    b, k, h, w = shape
    blocks = torch.rand((b, 3, h // 8 + 1, w // 8 + 1), generator=gen,
                        device='cuda')
    img = blocks.repeat_interleave(8, 2).repeat_interleave(8, 3)[
        :, :, :h, :w] + 0.05 * torch.rand((b, 3, h, w), generator=gen,
                                          device='cuda')
    kern = MeanFieldCRF().build_kernel(img).contiguous()
    targets = torch.zeros(shape, device='cuda')
    for i in range(b):
        for j in range(k):
            y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
            targets[i, j, y:y + rng.randint(2, h // 2 + 2),
                    x:x + rng.randint(2, w // 2 + 2)] = 1
    if k > 1:
        targets[0, -1] = 0
    scores = torch.rand(shape, generator=gen, device='cuda')
    bin0 = (scores * targets > 0.5).float()
    return kern, (0.5 * crf.kernel_sum(kern)).contiguous(), bin0, targets


def phase_crf_kernel():
    """K7 against the plain version, bit for bit, at the main path's shape
    and the others; its time beside the plain version's and its bound."""
    import numpy as np
    import torch
    from boxinstseg_tpu_torch.ops import crf
    gen = torch.Generator(device='cuda').manual_seed(4)
    rng = np.random.RandomState(4)
    report = {}
    for shape in (CRF_MAIN,) + CRF_SHAPES:
        kern, thresh, bin0, targets = crf_inputs(shape, gen, rng)
        got = crf.crf_mean_field_cuda(kern, thresh, bin0, targets, CRF_ITERS)
        want = crf.crf_mean_field_plain(kern, thresh, bin0, targets,
                                        CRF_ITERS)
        torch.cuda.synchronize()
        differ = int((got != want).sum().item())
        moved = int((want != bin0).sum().item())
        inside = int((targets > 0).sum().item())
        print(f'K7 {shape}: {differ} of {got.numel()} pixels differ from '
              f'plain; the rounds moved {moved} labels; {inside} target '
              f'pixels')
        if differ or not torch.equal(got, want):
            fail(f'K7 differs from its plain version at {shape}')
        if not moved:
            fail(f'K7 at {shape}: the rounds moved no label; check is '
                 f'vacuous')
        if shape == CRF_MAIN:
            # each input read once and the output written once; the
            # stencil's multiply-add per offset and round at target pixels
            # (elsewhere the state is 0 whatever the sum is)
            report['crf_mean_field'] = dict(
                max_abs_err=(got - want).abs().max().item(),
                ms=cuda_ms(lambda: crf.crf_mean_field_cuda(
                    kern, thresh, bin0, targets, CRF_ITERS)),
                plain_ms=cuda_ms(lambda: crf.crf_mean_field_plain(
                    kern, thresh, bin0, targets, CRF_ITERS), iters=5),
                library_ms=None,
                **bound(nbytes(kern, thresh, bin0, targets, bin0),
                        CRF_ITERS * 9 * 2 * inside))
    r = report['crf_mean_field']
    print(f'crf_mean_field at {CRF_MAIN}, {CRF_ITERS} rounds: kernel '
          f'{r["ms"]:.4f} ms, plain {r["plain_ms"]:.4f} ms, bound '
          f'{r["bound_ms"]:.4f} ms ({r["bound_by"]})')
    return report


def record_ema_gaps(step_cls, gaps):
    """Wrap ``step_cls.__call__`` so that each step appends the largest
    absolute difference between a teacher and a student parameter after
    it to ``gaps`` (a device scalar: no host wait in the step); returns the
    original to put back."""
    import torch
    call = step_cls.__call__

    def recorded(self, batch, i):
        logs = call(self, batch, i)
        with torch.no_grad():
            gaps.append(torch.stack(torch._foreach_norm(torch._foreach_sub(
                list(self.teacher.parameters()),
                list(self.model.parameters())), float('inf'))).amax())
        return logs
    step_cls.__call__ = recorded
    return call


def phase_discobox(tool):
    """5 SGD steps of DiscoBox R-50 3x through the train entry point, the
    teacher switched on after step DISCO_START_ITER."""
    import torch
    from boxinstseg_tpu_torch.engine.train_state import TSTrainStep
    from boxinstseg_tpu_torch.ops import crf
    register_dataset()
    work_dir = tempfile.mkdtemp(prefix='chip_smoke_disco_')
    seed = 0
    opts = [f'ts_cfg.start_iter={DISCO_START_ITER}',
            'runner.type=IterBasedRunner', f'runner.max_iters={STEPS}',
            'data.samples_per_gpu=2', 'data.train.type=SyntheticBoxDataset']
    try:
        cfg = tool.load_config(DISCO_CONFIG, opts, work_dir, seed)
        head, mf = cfg.model.bbox_head, cfg.model.mask_feat_head
        ob = head.loss_corr.obj_bank
        print(f'model: {describe_backbone(cfg.model.backbone)}, FPN '
              f'{cfg.model.neck.out_channels} P2-P6, {head.stacked_convs}x '
              f'{head.seg_feat_channels}-channel GN towers, grids '
              f'{list(head.num_grids)}, {head.ins_out_channels}-channel '
              f'kernels, mask feature {mf.out_channels}->{mf.num_classes}, '
              f'{head.num_classes} classes, max_pos {head.max_pos}, CRF '
              f'{head.loss_ts.max_iter} rounds, object bank '
              f'{head.num_classes}x{ob.len_object_queues}, ts_cfg '
              f'{dict(cfg.ts_cfg)}')
        torch.cuda.reset_peak_memory_stats()
        gaps = []
        call = record_ema_gaps(TSTrainStep, gaps)
        crf.crf_mean_field_cuda.launches = 0
        try:
            with live_gt_counts() as gts:
                result = tool.main([DISCO_CONFIG, '--work-dir', work_dir,
                                    '--seed', str(seed), '--device', 'cuda',
                                    '--cfg-options', *opts])
        finally:
            TSTrainStep.__call__ = call
        torch.cuda.synchronize()
        launches = {'crf_mean_field': crf.crf_mean_field_cuda.launches}
        peak = torch.cuda.max_memory_allocated()
        gaps = [g.item() for g in gaps]
        check_history(result, STEPS, required=('loss_ins', 'loss_cate'))
        if launches['crf_mean_field'] != STEPS:
            fail(f'K7 launched {launches["crf_mean_field"]} times in {STEPS}'
                 f' steps')
        teacher = [h['teacher_forward'] for h in result.history]
        if teacher != [float(i > DISCO_START_ITER) for i in range(STEPS)]:
            fail(f'the teacher ran in steps {teacher}')
        if [g == 0 for g in gaps] != [i < DISCO_START_ITER
                                      for i in range(STEPS)]:
            fail(f'EMA replica gap to the student by step: {gaps}')
        ckpt = torch.load(result.checkpoint, map_location='cpu')
        if not {'teacher_state_dict', 'object_bank'} <= set(ckpt):
            fail(f'checkpoint keys {sorted(ckpt)}')
        changed, _ = changed_tensors(tool, cfg, seed, result)
        for part in ('backbone.layer2.', 'neck.', 'bbox_head.kernel_convs.',
                     'bbox_head.solo_cate.', 'mask_feat_head.'):
            if not any(k.startswith(part) for k in changed):
                fail(f'no {part}* tensor changed in training')
        print(f'{len(changed)} tensors changed; launches {launches}; teacher '
              f'forward by step {teacher}; EMA gap by step '
              f'{[f"{g:.3g}" for g in gaps]}; avg_loss_ins by step '
              f'{[round(h["avg_loss_ins"], 5) for h in result.history]}')
        print_steps(result, peak, gts, teacher_after=DISCO_START_ITER)
        return launches
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def tiny_discobox_cfg():
    """ResNet-18, a 32-channel FPN, the correspondence loss with loose
    retrieval gates, a 16-slot bank and 8 queries."""
    return dict(
        type='DiscoBoxSOLOv2',
        backbone=dict(type='ResNet', depth=18, frozen_stages=1),
        neck=dict(type='FPN', in_channels=[64, 128, 256, 512],
                  out_channels=32, start_level=0, num_outs=5),
        bbox_head=dict(
            type='DiscoBoxSOLOv2Head', num_classes=4, in_channels=32,
            seg_feat_channels=16, stacked_convs=1,
            scale_ranges=((1, 48), (24, 96), (48, 192), (96, 384),
                          (192, 2048)),
            num_grids=[12, 10, 8, 6, 4], ins_out_channels=16,
            loss_ts=dict(max_iter=3), max_pos=8, max_corr_queries=8,
            loss_corr=dict(corr_num_iter=2, dist_kernel=5, obj_bank=dict(
                len_object_queues=16, fg_iou_thresh=0.5, bg_iou_thresh=0.5,
                appear_thresh=0.5, ratio_range=[0.5, 2.0], mask_height=14,
                mask_width=14, min_size=2))),
        mask_feat_head=dict(type='DiscoBoxMaskFeatHead', in_channels=32,
                            out_channels=16, num_classes=16,
                            norm_cfg=dict(type='GN', num_groups=8)))


def phase_discobox_reference():
    """The small DiscoBox, two teacher-student steps with the gates forced
    open (avg_loss_ins set to 0.1 before each), start_iter 0, every GT of
    one class so that the first step's appends are retrieved in the second:
    logs, the bank and the parameters on the card (K7) against the CPU
    (plain version). The kernel branch's last conv is scaled by 30 so that
    the mask scores sit away from the CRF's 0.5 threshold; the LR is 1e-4
    (see tests/test_torch_discobox.py)."""
    import numpy as np
    import torch
    from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
    from boxinstseg_tpu_torch.engine.train_state import TSTrainStep
    from boxinstseg_tpu_torch.ops import crf
    from boxinstseg_tpu_torch.ops.correspondence import create_object_bank
    from boxinstseg_tpu_torch.registry import build_detector
    rng = np.random.RandomState(0)
    b, h, w, g = 2, 128, 128, 4
    boxes = np.zeros((b, g, 4), np.float32)
    masks = np.zeros((b, g, h // 4, w // 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(rng.randint(2, g + 1)):
            x1, y1 = rng.randint(0, w - 48), rng.randint(0, h - 48)
            x2, y2 = x1 + rng.randint(24, 48), y1 + rng.randint(24, 48)
            boxes[i, j] = (x1, y1, x2, y2)
            masks[i, j, y1 // 4:y2 // 4 + 1, x1 // 4:x2 // 4 + 1] = 1
            valid[i, j] = True
    batch = dict(image=rng.rand(b, 3, h, w).astype(np.float32) * 4 - 2,
                 gt_bboxes=boxes, gt_masks=masks, gt_valid=valid,
                 gt_labels=np.ones((b, g), np.int64))
    cfg = tiny_discobox_cfg()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        init = build_detector(cfg).state_dict()
    init['bbox_head.solo_kernel.weight'] = \
        init['bbox_head.solo_kernel.weight'] * 30
    runs = {}
    for dev in ('cpu', 'cuda'):
        model = build_detector(cfg)
        model.load_state_dict(init)
        model.to(dev)
        opt = build_optimizer(dict(type='SGD', lr=1e-4, momentum=0.9,
                                   weight_decay=1e-4),
                              model.named_parameters())
        step = TSTrainStep(
            model, opt, lambda i: 1e-4, momentum=0.9, start_iter=0,
            bank=create_object_bank(4, 16, (7, 7), (14, 14), 32,
                                    device=dev))
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        before = crf.crf_mean_field_cuda.launches
        logs = []
        for i in range(2):
            step.avg_loss_ins = torch.tensor(0.1, device=dev)
            logs.append({k: v.item() for k, v in step(tb, i).items()})
        if (crf.crf_mean_field_cuda.launches - before) != (
                2 if dev == 'cuda' else 0):
            fail(f'the small DiscoBox on {dev} launched K7 '
                 f'{crf.crf_mean_field_cuda.launches - before} times')
        runs[dev] = (logs, {k: v.cpu() for k, v in
                            step.bank._asdict().items()},
                     {k: v.detach().cpu() for k, v in
                      model.state_dict().items()})
    (cpu_logs, cpu_bank, cpu_sd), (gpu_logs, gpu_bank, gpu_sd) = \
        runs['cpu'], runs['cuda']
    for i, (want, got) in enumerate(zip(cpu_logs, gpu_logs)):
        for k in want:
            if not math.isfinite(got[k]) or abs(got[k] - want[k]) > \
                    REF_ATOL + REF_RTOL * abs(want[k]):
                fail(f'step {i} {k} on the card {got[k]} vs CPU {want[k]}')
        print(f'step {i}: ' + ', '.join(f'{k} cuda {got[k]:.7g} cpu '
                                        f'{want[k]:.7g}' for k in want
                                        if k.startswith('loss')))
    if not cpu_logs[1]['loss_corr'] > 0:
        fail(f'no correspondence loss in the second step: {cpu_logs[1]}')
    for k in ('ptr', 'count'):
        if not torch.equal(gpu_bank[k], cpu_bank[k]):
            fail(f'bank {k} card {gpu_bank[k].tolist()} vs CPU '
                 f'{cpu_bank[k].tolist()}')
    for k in ('feat', 'mask', 'box'):
        err = (gpu_bank[k] - cpu_bank[k]).abs().max().item()
        if not err <= 1e-5:
            fail(f'bank {k} card vs CPU max abs err {err}')
    worst = 0.0
    for k, want in cpu_sd.items():
        if not want.is_floating_point():
            continue
        got = gpu_sd[k]
        if not torch.allclose(got, want, rtol=REF_RTOL, atol=REF_ATOL):
            fail(f'{k} after two steps: card vs CPU max abs err '
                 f'{(got - want).abs().max().item()}')
        worst = max(worst, (got - want).abs().max().item())
    print(f'bank count {cpu_bank["count"].tolist()}, ptr '
          f'{cpu_bank["ptr"].tolist()} on both; {len(cpu_sd)} tensors after '
          f'two steps within rtol {REF_RTOL} / atol {REF_ATOL} (max abs err '
          f'{worst:.3g})')


def main():
    if not os.path.isdir(os.path.join(ROOT, 'boxinstseg_tpu_torch')):
        fail(f'the boxinstseg_tpu_torch package is not beside {__file__}')
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke needs a GPU')
    t_start = time.perf_counter()

    phase('device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}, device '
          f'{torch.cuda.get_device_name(0)}; TF32 matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, cudnn '
          f'{torch.backends.cudnn.allow_tf32}')

    phase('build')
    from boxinstseg_tpu_torch.ops import _native
    t0 = time.perf_counter()
    _native.build_all(['pairwise', 'msda', 'lcm', 'swin_attention', 'crf'])
    print(f'pairwise.cu, msda.cu, lcm.cu, swin_attention.cu, crf.cu: '
          f'{time.perf_counter() - t0:.2f} s (nvcc ' + ', '.join(
              f'{k} {v:.2f} s' for k, v in _native.BUILD_SECONDS.items())
          + ')')

    phase('kernels')
    report = phase_kernels()
    report.update(phase_msda_kernels())
    report.update(phase_lcm_kernels())

    tool = load_train_tool()
    phase('slice')
    launches = phase_slice(tool)

    phase('reference')
    phase_reference()

    phase('box2mask')
    b2m_launches, _, _ = phase_box2mask(
        tool, B2M_CONFIG, 2, ('backbone.', 'panoptic_head.pixel_decoder.'
                              'encoder.', 'panoptic_head.transformer_decoder.'))
    launches.update(b2m_launches)

    phase('box2mask reference')
    phase_box2mask_reference()

    phase('swin kernels')
    report.update(phase_swin_kernels())

    phase('swin-l')
    swin_launches, cfg, model = phase_box2mask(
        tool, SWIN_CONFIG, 1, ('backbone.stages.0.', 'backbone.stages.2.',
                               'backbone.stages.3.',
                               'relative_position_bias_table'))
    bb = cfg.model.backbone
    if (bb.embed_dims, list(bb.depths), list(bb.num_heads),
            bb.window_size) != (192, [2, 2, 18, 2], [6, 12, 24, 48], 12):
        fail(f'not Swin-L: {describe_backbone(bb)}')
    launches['swin_attention_forward'] = \
        swin_launches['swin_attention_forward']
    launches['swin_attention_backward'] = \
        swin_launches['swin_attention_backward']
    phase_swin_predict(cfg, model)
    del model

    phase('swin reference')
    phase_swin_reference()

    phase('crf kernel')
    report.update(phase_crf_kernel())

    phase('discobox')
    launches.update(phase_discobox(tool))

    phase('discobox reference')
    phase_discobox_reference()

    kernels = [dict(name=name, route='cuda', source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    **report[name]) for name in REPLACES]
    print(f'smoke wall time {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(smi[0])
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
