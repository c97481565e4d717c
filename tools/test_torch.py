#!/usr/bin/env python
"""Evaluation entry point of the PyTorch / CUDA port (``boxinstseg_tpu_torch``).

Mirrors ``tools/test.py``: CONFIG and CHECKPOINT positional, --eval,
--max-images, --out, --save-results, --cfg-options, plus --device (cuda by
default, cpu for small runs on a host without a GPU). One process on one
device. The checkpoint is a ``.pth`` file: the port's own
(``tools/train_torch.py`` writes one) or an mmdet reference checkpoint.

    python tools/test_torch.py configs/boxinst/boxinst_r50_fpn_1x_coco.py \
        work_dirs/boxinst_torch/iter_90000.pth --eval bbox segm
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='Evaluate a detector (PyTorch port)')
    p.add_argument('config', help='config file path')
    p.add_argument('checkpoint', help='.pth checkpoint (port or mmdet)')
    p.add_argument('--eval', nargs='+', default=['bbox', 'segm'])
    p.add_argument('--max-images', type=int, default=None)
    p.add_argument('--out', help='save the metrics json here')
    p.add_argument('--save-results', help='save per-image results json')
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config, format key=value')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    return p.parse_args(argv)


def main(argv=None):
    """Run the evaluation; returns the metric dict."""
    args = parse_args(argv)
    import torch
    if args.device == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('--device cuda: no CUDA device is available')
    from boxinstseg_tpu_torch.apis.inference import init_detector
    from boxinstseg_tpu_torch.apis.test import run_evaluation
    from boxinstseg_tpu_torch.apis.train import get_logger
    from boxinstseg_tpu_torch.config import (Config, compat_cfg,
                                             replace_cfg_vals)
    from boxinstseg_tpu_torch.registry import build_dataset

    cfg = compat_cfg(replace_cfg_vals(Config.fromfile(args.config)))
    cfg.merge_from_dict(dict(kv.split('=', 1) for kv in args.cfg_options))
    model, cfg = init_detector(cfg, args.checkpoint, device=args.device)
    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    metrics = run_evaluation(model, dataset, cfg, metrics=args.eval,
                             max_images=args.max_images,
                             save_results=args.save_results)
    get_logger().info(f'metrics: {metrics}')
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == '__main__':
    main()
