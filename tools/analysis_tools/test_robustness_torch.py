#!/usr/bin/env python
"""Robustness benchmark of the PyTorch port, counterpart of
``tools/analysis_tools/test_robustness.py``: evaluate a model under image
corruptions at increasing severities and report each corruption's metrics
and the mPC-style mean.

    python tools/analysis_tools/test_robustness_torch.py CONFIG CKPT \
        [--corruptions gaussian_noise ...] [--severities 1 3 5] \
        [--eval bbox segm] [--max-images N] [--out summary.json] \
        [--device cpu]

The corruptions are the JAX tool's numpy / cv2 subset (gaussian_noise,
gaussian_blur, brightness, contrast, pixelate; the reference uses the
``imagecorruptions`` package), copied here with the same arithmetic. Each
is applied to the loaded BGR image, as a step right after the test
pipeline's image loading, and ``apis.test.run_evaluation`` runs once a
corruption and severity. ``tools/analysis_tools/robustness_eval.py`` reads
the ``--out`` json. ``--device`` is ``cuda`` by default (and raises
without a card).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

CORRUPTIONS = ('gaussian_noise', 'gaussian_blur', 'brightness', 'contrast',
               'pixelate')


def corrupt(img, corruption: str, severity: int):
    """img: HxWx3 uint8 BGR; severity 1..5."""
    import cv2
    import numpy as np
    s = severity
    if corruption == 'gaussian_noise':
        sigma = [4, 8, 12, 18, 26][s - 1]
        noise = np.random.RandomState(0).normal(0, sigma, img.shape)
        return np.clip(img.astype(np.float32) + noise, 0, 255).astype(
            np.uint8)
    if corruption == 'gaussian_blur':
        k = [3, 5, 7, 9, 11][s - 1]
        return cv2.GaussianBlur(img, (k, k), 0)
    if corruption == 'brightness':
        delta = [20, 40, 60, 80, 100][s - 1]
        return np.clip(img.astype(np.float32) + delta, 0, 255).astype(
            np.uint8)
    if corruption == 'contrast':
        f = [0.75, 0.6, 0.45, 0.3, 0.2][s - 1]
        mean = img.mean(axis=(0, 1), keepdims=True)
        return np.clip((img - mean) * f + mean, 0, 255).astype(np.uint8)
    if corruption == 'pixelate':
        f = [0.8, 0.65, 0.5, 0.35, 0.25][s - 1]
        h, w = img.shape[:2]
        small = cv2.resize(img, (max(int(w * f), 1), max(int(h * f), 1)),
                           interpolation=cv2.INTER_AREA)
        return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)
    raise ValueError(corruption)


class Corrupt:
    """Pipeline step: ``corrupt`` the loaded image in ``results['img']``."""

    def __init__(self, corruption: str, severity: int):
        self.corruption = corruption
        self.severity = severity

    def __call__(self, results):
        results['img'] = corrupt(results['img'], self.corruption,
                                 self.severity)
        return results


def corrupted_pipeline(pipeline, corruption, severity):
    """``pipeline`` (the test pipeline's steps) with a ``Corrupt`` step
    right after its image loading step."""
    steps = list(pipeline)
    load = [i for i, t in enumerate(steps)
            if isinstance(t, dict) and t.get('type', '').startswith(
                'LoadImage')]
    if not load:
        raise ValueError('the test pipeline has no LoadImage* step to '
                         'corrupt the image after')
    steps.insert(load[0] + 1, Corrupt(corruption, severity))
    return steps


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Robustness benchmark '
                                            '(PyTorch port)')
    p.add_argument('config')
    p.add_argument('checkpoint')
    p.add_argument('--corruptions', nargs='+', default=list(CORRUPTIONS))
    p.add_argument('--severities', nargs='+', type=int, default=[1, 3, 5])
    p.add_argument('--eval', nargs='+', default=['bbox', 'segm'])
    p.add_argument('--max-images', type=int, default=None)
    p.add_argument('--out', help='save summary json here')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    return p.parse_args(argv)


def main(argv=None):
    """Returns the summary: 'clean', each corruption's {severity:
    metrics}, 'mPC' and 'rPC'."""
    args = parse_args(argv)
    from boxinstseg_tpu_torch.apis.inference import (init_detector,
                                                     select_device)
    from boxinstseg_tpu_torch.apis.test import run_evaluation
    from boxinstseg_tpu_torch.registry import build_dataset

    model, cfg = init_detector(args.config, args.checkpoint,
                               device=select_device(args.device))
    test = dict(cfg.data['test'], test_mode=True)

    def evaluate(pipeline):
        return run_evaluation(model, build_dataset(dict(test,
                                                        pipeline=pipeline)),
                              cfg, metrics=args.eval,
                              max_images=args.max_images)

    summary = {'clean': evaluate(test['pipeline'])}
    for corr in args.corruptions:
        summary[corr] = {sev: evaluate(corrupted_pipeline(
            test['pipeline'], corr, sev)) for sev in args.severities}

    # mPC: mean over corruptions and severities of mAP
    key = f'{args.eval[0]}_mAP'
    vals = [per_sev[s][key] for c, per_sev in summary.items()
            if c != 'clean' for s in per_sev]
    summary['mPC'] = float(sum(vals) / max(len(vals), 1))
    summary['rPC'] = summary['mPC'] / max(summary['clean'][key], 1e-9)
    print(json.dumps(summary, indent=2, default=float))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(summary, f, indent=2, default=float)
    return summary


if __name__ == '__main__':
    main()
