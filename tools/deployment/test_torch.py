#!/usr/bin/env python
"""Evaluate a ``torch.export`` program, the PyTorch port's counterpart of
``tools/deployment/test.py``: the program from ``export_model_torch.py``
runs in place of the model inside ``apis.test.run_evaluation``, so the
frozen graph is checked end to end against the dataset.

    python tools/deployment/test_torch.py CONFIG model.pt2 \
        [--shape 800 1344] [--batch 1] [--eval segm] [--device cpu]

The program has one static (batch, h, w) signature: pass the ``--shape``
and ``--batch`` it was exported with; the loader is pinned to that canvas
and batch. It runs on the device it was exported on, which ``--device``
(``cuda`` by default, raising without a card) must name. Prints the
metrics JSON.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='Run COCO evaluation through an exported program')
    p.add_argument('config')
    p.add_argument('model', help='.pt2 program from export_model_torch.py')
    p.add_argument('--shape', type=int, nargs=2, default=[800, 1344],
                   help='canvas (h w) the program was exported with')
    p.add_argument('--batch', type=int, default=1)
    p.add_argument('--eval', nargs='+', default=['segm'])
    p.add_argument('--max-images', type=int, default=None)
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config, format key=value')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    return p.parse_args(argv)


def main(argv=None):
    """Returns the metric dict."""
    args = parse_args(argv)
    import torch
    from boxinstseg_tpu_torch.apis.export import ExportedDetector
    from boxinstseg_tpu_torch.apis.inference import (load_config,
                                                     select_device)
    from boxinstseg_tpu_torch.apis.test import run_evaluation
    from boxinstseg_tpu_torch.registry import build_dataset

    device = select_device(args.device)
    detector = ExportedDetector(torch.export.load(args.model))
    on = next(detector.parameters()).device
    if on.type != device.type:
        raise SystemExit(f'{args.model} was exported on {on}, not '
                         f'{device}: export it on the device it runs on')
    cfg = load_config(args.config, args.cfg_options)
    cfg.canvases = [tuple(args.shape)]      # the program's one signature
    cfg.data['samples_per_gpu'] = args.batch
    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    metrics = run_evaluation(detector, dataset, cfg, metrics=args.eval,
                             max_images=args.max_images)
    print(json.dumps(metrics, indent=2, default=float))
    return metrics


if __name__ == '__main__':
    main()
