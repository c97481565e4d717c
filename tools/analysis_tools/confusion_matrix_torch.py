#!/usr/bin/env python
"""Confusion matrix from saved detection results, the PyTorch port's copy
of ``tools/analysis_tools/confusion_matrix.py`` (reference surface:
tools/analysis_tools/confusion_matrix.py: config + results that
tools/test_torch.py --save-results writes, per-class greedy IoU>=thr
matching with an extra background row/column). Host only."""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('prediction_path',
                   help='json results from tools/test_torch.py '
                        '--save-results')
    p.add_argument('save_dir')
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--tp-iou-thr', type=float, default=0.5)
    p.add_argument('--show', action='store_true')
    p.add_argument('--color-theme', default='plasma')
    return p.parse_args(argv)


def calculate_confusion_matrix(dataset, results, score_thr, tp_iou_thr):
    import numpy as np
    from boxinstseg_tpu_torch.ops.boxes import bbox_overlaps_np
    n = len(dataset.CLASSES)
    cm = np.zeros((n + 1, n + 1))    # rows GT (+bg), cols pred (+bg)
    for idx, res in enumerate(results):
        ann = dataset.get_ann_info(idx)
        gts, gt_labels = ann['bboxes'], ann['labels']
        det = res['bboxes']
        keep = det[:, 4] >= score_thr
        det, det_labels = det[keep], res['labels'][keep]
        ious = bbox_overlaps_np(det[:, :4], gts) if len(det) and len(gts) \
            else None
        true_pos = set()
        for d in range(len(det)):
            matched = False
            if ious is not None and len(gts):
                g = int(ious[d].argmax())
                if ious[d, g] >= tp_iou_thr:
                    cm[gt_labels[g], det_labels[d]] += 1
                    true_pos.add(g)
                    matched = True
            if not matched:
                cm[n, det_labels[d]] += 1        # background -> pred (FP)
        for g in range(len(gts)):
            if g not in true_pos:
                cm[gt_labels[g], n] += 1         # GT -> background (FN)
    return cm


def plot_confusion_matrix(cm, classes, save_dir, color_theme='plasma',
                          show=False):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    import numpy as np
    norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1) * 100
    fig, ax = plt.subplots(figsize=(0.5 * len(classes) + 2,) * 2)
    im = ax.imshow(norm, cmap=color_theme)
    fig.colorbar(im)
    labels = list(classes) + ['background']
    ax.set_xticks(range(len(labels)))
    ax.set_yticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=45, ha='right', fontsize=6)
    ax.set_yticklabels(labels, fontsize=6)
    ax.set_xlabel('prediction')
    ax.set_ylabel('ground truth')
    fig.tight_layout()
    out = os.path.join(save_dir, 'confusion_matrix.png')
    fig.savefig(out, dpi=200)
    if show:
        plt.show()
    return out


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    from boxinstseg_tpu_torch.config import Config
    from boxinstseg_tpu_torch.registry import build_dataset

    cfg = Config.fromfile(args.config)
    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    with open(args.prediction_path) as f:
        raw = json.load(f)
    results = [dict(bboxes=np.asarray(r['bboxes'],
                                      np.float64).reshape(-1, 5),
                    labels=np.asarray(r['labels'], np.int64))
               for r in raw]
    cm = calculate_confusion_matrix(dataset, results, args.score_thr,
                                    args.tp_iou_thr)
    os.makedirs(args.save_dir, exist_ok=True)
    np.save(os.path.join(args.save_dir, 'confusion_matrix.npy'), cm)
    out = plot_confusion_matrix(cm, dataset.CLASSES, args.save_dir,
                                args.color_theme, args.show)
    print(f'saved {out}')
    return cm


if __name__ == '__main__':
    main()
