#!/usr/bin/env python
"""Profile the PyTorch port's train step on one GPU.

    python tools/profile_train_torch.py [CONFIG] [--steps 8] [--warmup 3]

Builds the config's model (random init from --seed), makes one batch of
seeded synthetic 800x1333 samples through ``StaticBatcher``, runs
``--warmup`` untimed steps, then times ``--steps`` steps on the host clock
(each ends in ``torch.cuda.synchronize()``) and traces the same number of
steps with ``torch.profiler``. Prints the wall ms/step, and for the traced
steps their wall ms/step, the device-busy ms a step (union of kernel
intervals) and the idle share (1 - busy / traced wall), and the top ops by
device time; the forward passes of backbone, neck, bbox_head and
mask_branch appear as ranges of their own. Writes the Chrome trace to
``--trace`` when given.
"""
import argparse
import importlib.util
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config', nargs='?', default=os.path.join(
        ROOT, 'configs/boxinst/boxinst_r50_fpn_1x_coco.py'))
    p.add_argument('--steps', type=int, default=8)
    p.add_argument('--warmup', type=int, default=3)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--top', type=int, default=25)
    p.add_argument('--trace', help='write a Chrome trace here')
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args()


def load_train_tool():
    spec = importlib.util.spec_from_file_location(
        'train_torch', os.path.join(ROOT, 'tools', 'train_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synthetic_samples(n, rng, h=800, w=1333, num_classes=80):
    """Seeded stand-ins for train-pipeline results, as ``StaticBatcher``
    takes them: a normalised image of flat 32x32 colour blocks (so the
    colour-similarity gates pass in places) with 1-8 boxes."""
    import numpy as np
    samples = []
    for _ in range(n):
        blocks = rng.randn(h // 32 + 1, w // 32 + 1, 3).astype(np.float32)
        img = np.repeat(np.repeat(blocks, 32, 0), 32, 1)[:h, :w]
        k = rng.randint(1, 9)
        x1, y1 = rng.randint(0, w - 400, k), rng.randint(0, h - 300, k)
        boxes = np.stack([x1, y1, x1 + rng.randint(32, 400, k),
                          y1 + rng.randint(32, 300, k)], 1)
        samples.append(dict(img=np.ascontiguousarray(img),
                            ori_shape=img.shape,
                            gt_bboxes=boxes.astype(np.float32),
                            gt_labels=rng.randint(0, num_classes, k)))
    return samples


def busy_ms(events):
    """Union length of the device kernel intervals (ms)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def annotate(module, name):
    """Wrap ``module``'s forward in a profiler range named ``name``."""
    from torch.profiler import record_function
    ranges = []
    module.register_forward_pre_hook(
        lambda m, a: ranges.append(record_function(name).__enter__()))
    module.register_forward_hook(
        lambda m, a, out: ranges.pop().__exit__(None, None, None))


def main():
    args = parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tool = load_train_tool()
    from boxinstseg_tpu_torch.apis.train import batch_to_device
    from boxinstseg_tpu_torch.data.batcher import StaticBatcher
    from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
    from boxinstseg_tpu_torch.engine.train_state import make_train_step

    cfg = tool.load_config(args.config, args.cfg_options, seed=args.seed)
    model = tool.build_model(cfg, args.seed).cuda()
    rng = np.random.RandomState(args.seed)
    bs = cfg.data.get('samples_per_gpu', 2)
    batcher = StaticBatcher(canvases=cfg.get('canvases'),
                            max_gts=cfg.get('max_gts', 100),
                            gt_buckets=cfg.get('gt_buckets'))
    batch = batch_to_device(
        batcher(synthetic_samples(bs, rng, num_classes=cfg.model.bbox_head
                                  .num_classes)), 'cuda')
    for name in ('backbone', 'neck', 'bbox_head', 'mask_branch'):
        annotate(getattr(model, name), f'forward:{name}')
    opt = build_optimizer(cfg.optimizer, model.parameters())
    step = make_train_step(model, opt, lambda i: cfg.optimizer['lr'])
    # the warmup counter past 0 so the pairwise term has a gradient
    it = cfg.model.mask_head.get('pairwise_warmup', 10000)
    for _ in range(args.warmup):
        step(batch, it)
    torch.cuda.synchronize()

    wall = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(batch, it)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            with record_function('train_step'):
                step(batch, it)
        torch.cuda.synchronize()
        traced = 1e3 * (time.perf_counter() - t0) / args.steps
    kernels = [e for e in prof.events()
               if e.device_type.name == 'CUDA'
               and not getattr(e, 'is_user_annotation', False)
               and e.time_range.end > e.time_range.start]
    busy = busy_ms(kernels) / args.steps
    med = statistics.median(wall)
    print(f'{torch.cuda.get_device_name(0)}; batch {bs}, canvas '
          f'{tuple(batch["image"].shape[-2:])}')
    print(f'wall ms/step: median {med:.3f} (min {min(wall):.3f}, max '
          f'{max(wall):.3f}); traced steps: wall {traced:.3f} ms/step, '
          f'device busy {busy:.3f} ms/step, idle share '
          f'{1 - busy / traced:.3f}; kernels/step '
          f'{len(kernels) / args.steps:.0f}')
    print(prof.key_averages().table(sort_by='cuda_time_total',
                                    row_limit=args.top,
                                    max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == '__main__':
    main()
