#!/usr/bin/env python
"""Speed of predict (images/s) or of the train step (ms/step), the PyTorch
port's counterpart of ``tools/analysis_tools/benchmark.py``, for any
config family on synthetic batches.

    python tools/analysis_tools/benchmark_torch.py CONFIG [--batch-size 1]
        [--height 800] [--width 1344] [--iters 20] [--train]
        [--max-gts 32] [--bf16] [--cfg-options K=V ...] [--device cpu]

Predict runs ``model.predict`` (random weights from seed 0, eval
mode, ``torch.inference_mode()``) on a seeded random image batch;
``--train`` runs the config's train step (its optimizer; DiscoBox with the
teacher's forward) on ``tools/profile_train_torch.py``'s seeded synthetic
boxes at ``--batch-size`` and ``--max-gts``. ``--bf16`` runs
both under bf16 autocast, as a config's precision key does. Each timed
iteration starts and ends with ``torch.cuda.synchronize()`` (on the card),
so a clock read never sees queued work. Prints the median over ``--iters``
after 3 untimed ones, with the min and the max, the peak device
memory, and the card's name and power limit (``nvidia-smi``). ``--device``
is ``cuda`` by default (and raises without a card); ``--device cpu``
times the CPU and says so.
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

WARMUP = 3            # untimed iterations before the timed ones
SEED = 0              # the weights and the synthetic inputs


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Predict / train-step speed '
                                            '(PyTorch port)')
    p.add_argument('config')
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--height', type=int, default=800)
    p.add_argument('--width', type=int, default=1344)
    p.add_argument('--iters', type=int, default=20)
    p.add_argument('--train', action='store_true',
                   help='time the train step instead of predict')
    p.add_argument('--max-gts', type=int, default=32)
    p.add_argument('--bf16', action='store_true')
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config, format key=value')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    return p.parse_args(argv)


def _tool(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_setup(cfg, model, device, seed, batch_size, canvas, max_gts):
    """The config's train step for ``model`` (its optimizer and grad clip;
    DiscoBox's teacher-student step past ``start_iter``, so the teacher's
    forward runs), the iteration to run it at (past the pairwise warmup)
    and one batch of ``tools/profile_train_torch.py``'s seeded synthetic
    samples at ``canvas`` with ``max_gts`` GT slots."""
    import numpy as np
    from boxinstseg_tpu_torch.apis.train import (apply_precision_policy,
                                                 batch_to_device,
                                                 build_object_bank)
    from boxinstseg_tpu_torch.data.batcher import StaticBatcher
    from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
    from boxinstseg_tpu_torch.engine.train_state import (TSTrainStep,
                                                         make_train_step)
    from boxinstseg_tpu_torch.models.detectors.single_stage_ts import \
        SingleStageWSInsTSDetector
    with_masks = bool(cfg.get('with_gt_masks', False))
    head = cfg.model.get('bbox_head') or cfg.model.get('panoptic_head')
    samples = _tool('profile_train_torch').synthetic_samples(
        batch_size, np.random.RandomState(seed), *canvas,
        num_classes=head.get('num_classes', head.get('num_things_classes')),
        with_masks=with_masks)
    batch = batch_to_device(StaticBatcher(
        canvases=[tuple(canvas)], max_gts=max_gts, with_masks=with_masks,
        mask_stride=4)(samples), device)
    opt = build_optimizer(cfg.optimizer, model.named_parameters())
    grad_clip = (cfg.get('optimizer_config') or {}).get('grad_clip')
    bf16 = apply_precision_policy(cfg)
    if isinstance(model, SingleStageWSInsTSDetector):
        ts_cfg = dict(cfg.get('ts_cfg') or {})
        step = TSTrainStep(
            model, opt, lambda i: cfg.optimizer['lr'], grad_clip,
            momentum=ts_cfg.get('momentum', 0.999),
            start_iter=ts_cfg.get('start_iter', 13000),
            ts_thresh=ts_cfg.get('ts_thresh', 0.3),
            corr_thresh=ts_cfg.get('corr_thresh', 0.2),
            bank=build_object_bank(cfg, device), bf16=bf16)
        return step, step.start_iter + 1, batch
    step = make_train_step(model, opt, lambda i: cfg.optimizer['lr'],
                           grad_clip, bf16=bf16)
    return step, (cfg.model.get('mask_head') or {}).get(
        'pairwise_warmup', 10000), batch


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != 'cuda':
        return 'device cpu (no card)'
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '-i', str(device.index or 0)],
        capture_output=True, text=True, check=True).stdout.strip()


def timed(fn, iters, warmup, device):
    """Seconds of each of ``iters`` calls of ``fn`` after ``warmup`` untimed
    ones; on the card each call lies between two synchronizes."""
    import torch

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return times


def main(argv=None):
    """Returns a dict of the numbers printed."""
    args = parse_args(argv)
    import numpy as np
    import torch
    from boxinstseg_tpu_torch.apis.inference import select_device
    from boxinstseg_tpu_torch.engine.train_state import autocast_bf16
    from boxinstseg_tpu_torch.utils.env import set_tf32, tf32_from_cfg

    device = select_device(args.device)
    if device.type == 'cuda':
        device = torch.device('cuda', torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(device)
    train_tool = _tool('train_torch')
    cfg = train_tool.load_config(args.config, args.cfg_options,
                                 seed=SEED)
    if args.bf16:
        cfg.bf16 = True
    set_tf32(tf32_from_cfg(cfg))
    model = train_tool.build_model(cfg, SEED).to(device)
    b, h, w = args.batch_size, args.height, args.width

    if args.train:
        step, it, batch = train_setup(cfg, model, device, SEED, b,
                                      (h, w), args.max_gts)
        times = timed(lambda: step(batch, it), args.iters, WARMUP,
                      device)
    else:
        rng = np.random.RandomState(SEED)
        batch = dict(
            image=torch.from_numpy(rng.randn(b, 3, h, w).astype(
                np.float32)).to(device),
            img_shape=torch.tensor([[h, w]] * b, dtype=torch.int32,
                                   device=device),
            scale_factor=torch.ones((b, 4), device=device))
        model.eval()

        def predict():
            with torch.inference_mode(), autocast_bf16(device, args.bf16):
                return model.predict(batch)
        times = timed(predict, args.iters, WARMUP, device)

    med = statistics.median(times)
    res = dict(kind='train' if args.train else 'predict', batch=b,
               canvas=(h, w), iters=args.iters, median_ms=1e3 * med,
               min_ms=1e3 * min(times), max_ms=1e3 * max(times),
               images_per_s=b / med, device=card_line(device),
               precision='bf16 autocast' if args.bf16 else 'fp32')
    if device.type == 'cuda':
        res['peak_gib'] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    what = 'ms/step' if args.train else 'ms/batch'
    print(f'{res["kind"]}: {res["images_per_s"]:.3f} images/s; {what} '
          f'median {res["median_ms"]:.3f} (min {res["min_ms"]:.3f}, max '
          f'{res["max_ms"]:.3f}) over {args.iters} after {WARMUP} '
          f'warm-up; batch {b} at {h}x{w}, {res["precision"]}'
          + (f'; peak {res["peak_gib"]:.3f} GiB' if 'peak_gib' in res
             else ''))
    print(f'on {res["device"]}')
    return res


if __name__ == '__main__':
    main()
