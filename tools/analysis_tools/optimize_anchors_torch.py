#!/usr/bin/env python
"""Optimize YOLO-style anchor settings on a dataset, the PyTorch port's
copy of ``tools/analysis_tools/optimize_anchors.py`` (reference:
tools/analysis_tools/optimize_anchors.py — k-means :151-221 and
differential-evolution :223-319 optimizers over GT box widths / heights,
resized to the training input shape). The dataset comes from the port's
config and registry; the optimizers are host numpy / scipy, as there.

Example:
    python tools/analysis_tools/optimize_anchors_torch.py CONFIG \
        --algorithm k-means --num-anchors 9 --input-shape 608 608 \
        --output-dir work_dirs/
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Optimize anchor parameters.')
    p.add_argument('config')
    p.add_argument('--input-shape', type=int, nargs='+', default=[608, 608],
                   help='[width, height] the boxes are rescaled to')
    p.add_argument('--algorithm', default='differential_evolution',
                   choices=['k-means', 'differential_evolution'])
    p.add_argument('--num-anchors', type=int, default=9)
    p.add_argument('--iters', type=int, default=1000)
    p.add_argument('--output-dir', default=None)
    p.add_argument('--seed', type=int, default=0)
    return p.parse_args(argv)


def collect_whs(dataset, input_shape):
    """GT (w, h) pairs rescaled by the keep-ratio resize to input_shape
    (reference get_whs_and_shapes + the ratio division at :92-95)."""
    whs, shapes = [], []
    for idx in range(len(dataset)):
        ann = dataset.get_ann_info(idx)
        info = dataset.data_infos[idx]
        img_shape = np.array([info['width'], info['height']], np.float64)
        for bbox in np.asarray(ann['bboxes']).reshape(-1, 4):
            whs.append(bbox[2:4] - bbox[0:2])
            shapes.append(img_shape)
    whs = np.asarray(whs, np.float64)
    shapes = np.asarray(shapes, np.float64)
    scale = np.max(shapes / np.asarray(input_shape, np.float64), axis=1)
    return whs / scale[:, None]


def wh_iou(whs, centers):
    """(n, 2) x (k, 2) IoU of zero-centered boxes."""
    inter = np.minimum(whs[:, None, 0], centers[None, :, 0]) * \
        np.minimum(whs[:, None, 1], centers[None, :, 1])
    union = whs[:, 0:1] * whs[:, 1:2] + \
        (centers[:, 0] * centers[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def kmeans_anchors(whs, num_anchors, iters, rng):
    """Darknet-style IoU k-means (reference kmeans_anchors :170-221)."""
    centers = whs[rng.integers(0, whs.shape[0], num_anchors)]
    assignments = np.zeros(whs.shape[0], np.int64)
    for i in range(iters):
        new_assign = wh_iou(whs, centers).argmax(1)
        if (new_assign == assignments).all() and i > 0:
            print(f'K-means converged at iter {i}')
            break
        assignments = new_assign
        for k in range(num_anchors):
            sel = assignments == k
            if sel.any():
                centers[k] = whs[sel].mean(0)
    avg_iou = wh_iou(whs, centers).max(1).mean()
    print(f'Average IoU of anchors: {avg_iou:.4f}')
    return sorted(centers.tolist(), key=lambda x: x[0] * x[1])


def avg_iou_cost(params, whs):
    centers = np.asarray(params, np.float64).reshape(-1, 2)
    return 1.0 - wh_iou(whs, centers).max(1).mean()


def de_anchors(whs, num_anchors, iters, input_shape, seed):
    """scipy differential evolution over anchor (w, h) params
    (reference differential_evolution :282-319)."""
    from scipy.optimize import differential_evolution
    bounds = [(1, input_shape[0]), (1, input_shape[1])] * num_anchors
    result = differential_evolution(
        avg_iou_cost, bounds=bounds, args=(whs,), strategy='best1bin',
        maxiter=iters, popsize=15, tol=0.001, mutation=(0.5, 1),
        recombination=0.7, updating='immediate', disp=True, seed=seed)
    print(f'Anchor evolution finished, average IoU: {1 - result.fun:.4f}')
    centers = result.x.reshape(-1, 2)
    return sorted(centers.tolist(), key=lambda x: x[0] * x[1])


def main(argv=None):
    """Returns the anchors as printed (rounded (w, h) pairs)."""
    args = parse_args(argv)
    from boxinstseg_tpu_torch.config import (Config, compat_cfg,
                                             replace_cfg_vals)
    from boxinstseg_tpu_torch.registry import build_dataset
    cfg = compat_cfg(replace_cfg_vals(Config.fromfile(args.config)))
    train = dict(cfg.data['train'])
    while train.get('type') in ('RepeatDataset', 'ClassBalancedDataset',
                                'MultiImageMixDataset'):
        train = dict(train['dataset'])
    dataset = build_dataset(train)

    whs = collect_whs(dataset, args.input_shape)
    print(f'Collected {whs.shape[0]} bboxes.')
    rng = np.random.default_rng(args.seed)
    if args.algorithm == 'k-means':
        anchors = kmeans_anchors(whs, args.num_anchors, args.iters, rng)
    else:
        anchors = de_anchors(whs, args.num_anchors, args.iters,
                             args.input_shape, args.seed)
    anchors = [[round(w), round(h)] for w, h in anchors]
    print(f'Anchor optimize result: {anchors}')
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        path = os.path.join(args.output_dir,
                            'anchor_optimize_result.json')
        with open(path, 'w') as f:
            json.dump(anchors, f)
        print(f'Result saved in {path}')
    return anchors


if __name__ == '__main__':
    main()
