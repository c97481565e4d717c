#!/usr/bin/env python
"""Profile the PyTorch port's train step on one GPU.

    python tools/profile_train_torch.py [CONFIG] [--steps 8] [--warmup 3]

Builds the config's model (random init from --seed) and its optimizer
(paramwise multipliers and grad clip as the config sets them), makes one
batch of seeded synthetic samples of the config's first canvas size through
``StaticBatcher`` (with box bitmasks at stride 4 when the config trains on
GT masks, as Box2Mask and DiscoBox do), runs ``--warmup`` untimed steps,
then times ``--steps`` steps on the host clock (each ends in
``torch.cuda.synchronize()``) and traces the same number of steps with
``torch.profiler``. A DiscoBox config takes the teacher-student step with
its object bank, and is measured twice, each time with its own warm-up:
at ``ts_cfg.start_iter`` (no teacher forward) and past it (the EMA
teacher's forward runs). A config without ``canvases`` uses the largest
of the train pipeline's default canvases. Prints the wall ms/step, and for
the traced steps their wall ms/step, the device-busy ms a step (union of
kernel intervals) and the idle share (1 - busy / traced wall), and the top
ops by device time, and the device ms a step of the kernels whose names
hold each ``--kernels`` string (the pairwise pair's by default). Busy and
idle are of the traced steps only: the
profiler adds host and device cost, so they are not compared with the
untraced wall. The forward passes of the model's parts (backbone,
neck, bbox_head, mask_branch, mask_feat_head; panoptic_head and its
pixel_decoder) and the panoptic, DiscoBox and BoxLevelset heads' losses
appear as ranges
of their own. Writes the Chrome trace to ``--trace`` when given (for a
DiscoBox config one a kind of step, its name before the extension).
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
    p.add_argument('--kernels', nargs='+', default=['pairwise_'],
                   help='print the device ms a step of the kernels whose '
                        'names hold each of these')
    p.add_argument('--cfg-options', nargs='+', default=[])
    return p.parse_args()


def load_train_tool():
    spec = importlib.util.spec_from_file_location(
        'train_torch', os.path.join(ROOT, 'tools', 'train_torch.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synthetic_samples(n, rng, h, w, num_classes=80, with_masks=False):
    """Seeded stand-ins for train-pipeline results, as ``StaticBatcher``
    takes them: a normalised image of flat 32x32 colour blocks (so the
    colour-similarity gates pass in places) with 1-8 boxes, and their box
    bitmasks when ``with_masks``."""
    import numpy as np
    samples = []
    for _ in range(n):
        blocks = rng.randn(h // 32 + 1, w // 32 + 1, 3).astype(np.float32)
        img = np.repeat(np.repeat(blocks, 32, 0), 32, 1)[:h, :w]
        k = rng.randint(1, 9)
        bw = rng.randint(32, min(400, w // 2), k)
        bh = rng.randint(32, min(300, h // 2), k)
        x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
        boxes = np.stack([x1, y1, x1 + bw, y1 + bh], 1)
        sample = dict(img=np.ascontiguousarray(img), ori_shape=img.shape,
                      gt_bboxes=boxes.astype(np.float32),
                      gt_labels=rng.randint(0, num_classes, k))
        if with_masks:
            masks = np.zeros((k, h, w), np.uint8)
            for m, (bx1, by1, bx2, by2) in zip(masks, boxes):
                m[by1:by2 + 1, bx1:bx2 + 1] = 1
            sample['gt_masks'] = masks
        samples.append(sample)
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


def annotate_method(obj, attr, name):
    """Run ``obj.attr(...)`` inside a profiler range named ``name``."""
    from torch.profiler import record_function
    fn = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    setattr(obj, attr, wrapped)


def main():
    args = parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    tool = load_train_tool()
    from boxinstseg_tpu_torch.apis.train import (apply_precision_policy,
                                                 batch_to_device,
                                                 build_object_bank,
                                                 default_canvases)
    from boxinstseg_tpu_torch.data.batcher import StaticBatcher
    from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
    from boxinstseg_tpu_torch.engine.train_state import (TSTrainStep,
                                                         make_train_step)
    from boxinstseg_tpu_torch.utils.env import set_tf32, tf32_from_cfg
    from boxinstseg_tpu_torch.models.detectors.single_stage_boxseg import \
        SingleStageBoxInsDetector
    from boxinstseg_tpu_torch.models.detectors.single_stage_ts import \
        SingleStageWSInsTSDetector

    cfg = tool.load_config(args.config, args.cfg_options, seed=args.seed)
    set_tf32(tf32_from_cfg(cfg))
    model = tool.build_model(cfg, args.seed).cuda()
    rng = np.random.RandomState(args.seed)
    bs = cfg.data.get('samples_per_gpu', 2)
    canvases = cfg.get('canvases') or [max(default_canvases(cfg),
                                           key=lambda c: c[0] * c[1])]
    with_masks = bool(cfg.get('with_gt_masks', False))
    batcher = StaticBatcher(canvases=canvases,
                            max_gts=cfg.get('max_gts', 100),
                            gt_buckets=cfg.get('gt_buckets'),
                            with_masks=with_masks, mask_stride=4)
    head = cfg.model.get('bbox_head') or cfg.model.get('panoptic_head')
    num_classes = head.get('num_classes', head.get('num_things_classes'))
    batch = batch_to_device(batcher(synthetic_samples(
        bs, rng, *canvases[0], num_classes=num_classes,
        with_masks=with_masks)), 'cuda')
    for name in ('backbone', 'neck', 'bbox_head', 'mask_branch',
                 'mask_feat_head', 'panoptic_head'):
        if getattr(model, name, None) is not None:
            annotate(getattr(model, name), f'forward:{name}')
    if getattr(model, 'panoptic_head', None) is not None:
        annotate(model.panoptic_head.pixel_decoder, 'forward:pixel_decoder')
        annotate_method(model.panoptic_head, 'loss', 'loss:panoptic_head')
    opt = build_optimizer(cfg.optimizer, model.named_parameters())
    grad_clip = (cfg.get('optimizer_config') or {}).get('grad_clip')
    bf16 = apply_precision_policy(cfg)
    if isinstance(model, (SingleStageWSInsTSDetector,
                          SingleStageBoxInsDetector)):
        annotate_method(model.bbox_head, 'loss', 'loss:bbox_head')
    if isinstance(model, SingleStageWSInsTSDetector):
        ts_cfg = dict(cfg.get('ts_cfg') or {})
        step = TSTrainStep(
            model, opt, lambda i: cfg.optimizer['lr'], grad_clip,
            momentum=ts_cfg.get('momentum', 0.999),
            start_iter=ts_cfg.get('start_iter', 13000),
            ts_thresh=ts_cfg.get('ts_thresh', 0.3),
            corr_thresh=ts_cfg.get('corr_thresh', 0.2),
            bank=build_object_bank(cfg, 'cuda'), bf16=bf16)
        # at start_iter the teacher's forward does not run, past it it does
        kinds = [('without the teacher', step.start_iter),
                 ('with the teacher', step.start_iter + 1)]
    else:
        step = make_train_step(model, opt, lambda i: cfg.optimizer['lr'],
                               grad_clip, bf16=bf16)
        # the warmup counter past 0 so the pairwise term has a gradient
        kinds = [('', (cfg.model.get('mask_head') or {}).get(
            'pairwise_warmup', 10000))]
    print(f'{torch.cuda.get_device_name(0)}; batch {bs}, canvas '
          f'{tuple(batch["image"].shape[-2:])}; '
          f'{"bf16 autocast" if bf16 else "fp32"} (the config\'s precision)')
    for label, it in kinds:
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
        print(f'steps {label}: ' if label else '', end='')
        print(f'wall ms/step: median {med:.3f} (min {min(wall):.3f}, max '
              f'{max(wall):.3f}); traced steps: wall {traced:.3f} ms/step, '
              f'device busy {busy:.3f} ms/step, idle share '
              f'{1 - busy / traced:.3f}; kernels/step '
              f'{len(kernels) / args.steps:.0f}')
        for part in args.kernels:
            hit = [e for e in kernels if part in e.name]
            ms = sum(e.time_range.end - e.time_range.start
                     for e in hit) / 1e3 / args.steps
            print(f'kernels named *{part}*: {len(hit) / args.steps:.0f} a '
                  f'step, {ms:.4f} device ms a step')
        print(prof.key_averages().table(sort_by='cuda_time_total',
                                        row_limit=args.top,
                                        max_name_column_width=60))
        if args.trace:
            root, ext = os.path.splitext(args.trace)
            prof.export_chrome_trace(
                f'{root}_{label.replace(" ", "_")}{ext}' if label
                else args.trace)


if __name__ == '__main__':
    main()
