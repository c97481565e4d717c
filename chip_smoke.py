#!/usr/bin/env python
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. device   - card name and power limit (nvidia-smi), torch / CUDA versions;
              TF32 off for matmuls and convolutions.
2. build    - compiles the hand-written kernels (csrc/*.cu) with nvcc.
3. kernels  - each kernel against its plain PyTorch version on the card, at
              the main path's shape and at ragged ones; errors and times.
4. slice    - BoxInst R-50-FPN 1x at full width (random init from a seed)
              trained for 5 SGD steps through tools/train_torch.py on seeded
              synthetic 800x1333 images; the kernels' launch counts over
              that run must equal the step count.
5. reference- a small CondInst's loss dict on the card (kernels) against
              the same weights and batch on the CPU (plain versions).

Prints a JSON line with one entry per kernel, the card's nvidia-smi line,
and as its last line {"ok": true, "device": {...}}.
"""
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
STEPS = 5
MAIN_SHAPE = (2, 64, 200, 336)     # B, K=topk_per_img, 800/4, 1344/4
RAGGED_SHAPES = ((1, 3, 37, 53), (2, 5, 37, 53))
VALUE_RTOL = 1e-5                  # fp32, summation order
# on the unnormalised gradient d(num)/d(logits), whose entries are O(1);
# through autograd it is divided by max(den, 1), and so is GRAD_ATOL
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5
REF_RTOL, REF_ATOL = 1e-4, 1e-6    # cuDNN vs CPU conv summation order


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


class SyntheticBoxDataset:
    """Seeded stand-in for CocoDataset with the interface TrainLoader uses
    (``flag``, ``__len__``, ``prepare(idx, rng, scale)``).

    Each sample is a uint8 BGR image of ``img_h`` x ``img_w`` made of flat
    32x32 colour blocks with 1-8 solid-colour boxes on top (flat regions
    give the colour-similarity gates something to pass), sent through the
    config's train pipeline after the file-loading and resize steps, which
    the synthesis replaces: RandomFlip, Normalize, Pad, DefaultFormatBundle
    and Collect. No cv2 is needed."""

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
            report['pairwise_forward'] = dict(
                max_abs_err=v_err,
                ms=cuda_ms(lambda: pw.pairwise_forward_cuda(x, sim, bm,
                                                            valid)),
                plain_ms=cuda_ms(lambda: pw.pairwise_num_den_plain(
                    x, sim, bm, valid)))
            report['pairwise_backward'] = dict(
                max_abs_err=g_err,
                ms=cuda_ms(lambda: pw.pairwise_grad_cuda(x, sim, bm, valid,
                                                         scale)),
                plain_ms=cuda_ms(lambda: pw.pairwise_grad_plain(
                    x, sim, bm, valid) * scale))
    for name, r in report.items():
        print(f'{name} at {MAIN_SHAPE}: kernel {r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms')
    return report


def phase_slice(tool):
    """5 SGD steps of BoxInst R-50-FPN 1x through the train entry point."""
    import torch
    from boxinstseg_tpu_torch.ops import pairwise as pw
    from boxinstseg_tpu_torch.registry import DATASETS
    if 'SyntheticBoxDataset' not in DATASETS:
        DATASETS.register_module(module=SyntheticBoxDataset)
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
        result = tool.main([CONFIG, '--work-dir', work_dir, '--seed',
                            str(seed), '--device', 'cuda',
                            '--cfg-options', *opts])
        torch.cuda.synchronize()
        launches = {'pairwise_forward': pw.pairwise_forward_cuda.launches,
                    'pairwise_backward': pw.pairwise_grad_cuda.launches}
        peak = torch.cuda.max_memory_allocated()
        if result.step != STEPS:
            fail(f'ran {result.step} steps, expected {STEPS}')
        for i, logs in enumerate(result.history):
            bad = [k for k, v in logs.items() if not math.isfinite(v)]
            if bad:
                fail(f'step {i}: non-finite {bad}')
            if i > 0 and not logs['loss_pairwise'] > 0:
                fail(f'step {i}: loss_pairwise {logs["loss_pairwise"]}')
        for name, n in launches.items():
            if n != STEPS:
                fail(f'{name} launched {n} times in {STEPS} steps')
        init = tool.build_model(cfg, seed).state_dict()
        final = torch.load(result.checkpoint, map_location='cpu')
        if final['_iter'] != STEPS:
            fail(f'checkpoint _iter {final["_iter"]}')
        changed = [k for k, v in final['state_dict'].items()
                   if v.is_floating_point() and not torch.equal(v, init[k])]
        if not changed:
            fail('no parameter changed in training')
        step_ms = [1e3 * (h['time'] - h['data_time'])
                   for h in result.history]
        print(f'losses at step {STEPS}: ' + ', '.join(
            f'{k} {v:.5f}' for k, v in result.history[-1].items()
            if k.startswith('loss')))
        print(f'{len(changed)} tensors changed; launches {launches}')
        print(f'step ms (compute + sync, data excluded): '
              f'{[round(t, 3) for t in step_ms]}; median of steps 2-{STEPS}'
              f' {statistics.median(step_ms[1:]):.3f} ms; peak memory '
              f'{peak / 2**30:.3f} GiB')
        return launches
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


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


def phase_reference():
    """Small CondInst: loss dict on the card vs the CPU plain path."""
    import numpy as np
    import torch
    from boxinstseg_tpu_torch.registry import build_detector
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
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_detector(tiny_cfg()).train()
    losses = {}
    for dev in ('cpu', 'cuda'):
        model.to(dev)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        state = {k: v.clone() for k, v in model.state_dict().items()}
        losses[dev] = {k: v.item() for k, v in model.loss(tb, 50).items()}
        model.load_state_dict(state)      # undo the BN running-stat update
    for k, want in losses['cpu'].items():
        got = losses['cuda'][k]
        print(f'{k}: cuda {got:.7g} cpu {want:.7g}')
        if not math.isfinite(got) or abs(got - want) > REF_ATOL \
                + REF_RTOL * abs(want):
            fail(f'{k} on the card {got} vs CPU {want}')


def main():
    if not os.path.isdir(os.path.join(ROOT, 'boxinstseg_tpu_torch')):
        fail(f'the boxinstseg_tpu_torch package is not beside {__file__}')
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke needs a GPU')

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
    from boxinstseg_tpu_torch.ops import _native, pairwise as pw
    t0 = time.perf_counter()
    pw._lib()
    print(f'pairwise.cu: {time.perf_counter() - t0:.2f} s '
          f'(nvcc {_native.BUILD_SECONDS["pairwise"]:.2f} s)')

    phase('kernels')
    report = phase_kernels()

    phase('slice')
    launches = phase_slice(load_train_tool())

    phase('reference')
    phase_reference()

    replaces = {'pairwise_forward':
                'boxinstseg_tpu/ops/pallas_kernels.py:32',
                'pairwise_backward':
                'boxinstseg_tpu/ops/pallas_kernels.py:119'}
    kernels = [dict(name=name, route='cuda',
                    source='boxinstseg_tpu_torch/csrc/pairwise.cu',
                    replaces=replaces[name], launches=launches[name],
                    **report[name]) for name in ('pairwise_forward',
                                                 'pairwise_backward')]
    print(json.dumps({'kernels': kernels}))
    print(smi[0])
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
