#!/usr/bin/env python
"""Rank evaluated images by per-image detection quality and save the best /
worst visualizations, the PyTorch port's copy of
``tools/analysis_tools/analyze_results.py`` (reference surface:
tools/analysis_tools/analyze_results.py: config + saved results + out dir,
the same per-image ranking). Host only."""
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
    p.add_argument('show_dir')
    p.add_argument('--topk', type=int, default=20)
    p.add_argument('--show-score-thr', type=float, default=0.3)
    return p.parse_args(argv)


def image_score(res, ann, iou_thr=0.5, score_thr=0.3):
    """Simple per-image quality: F1 of IoU>=.5 matches at score>=thr."""
    import numpy as np
    from boxinstseg_tpu_torch.ops.boxes import bbox_overlaps_np
    det = res['bboxes']
    keep = det[:, 4] >= score_thr
    det, det_labels = det[keep], res['labels'][keep]
    gts, gt_labels = ann['bboxes'], ann['labels']
    if len(gts) == 0:
        return 1.0 if len(det) == 0 else 0.0
    if len(det) == 0:
        return 0.0
    ious = bbox_overlaps_np(det[:, :4], gts)
    matched_gt = set()
    tp = 0
    for d in np.argsort(-det[:, 4]):
        cands = [g for g in range(len(gts))
                 if g not in matched_gt and gt_labels[g] == det_labels[d]
                 and ious[d, g] >= iou_thr]
        if cands:
            g = max(cands, key=lambda g: ious[d, g])
            matched_gt.add(g)
            tp += 1
    prec = tp / len(det)
    rec = tp / len(gts)
    return 2 * prec * rec / max(prec + rec, 1e-9)


def main(argv=None):
    args = parse_args(argv)
    import cv2
    import numpy as np
    from boxinstseg_tpu_torch.config import Config
    from boxinstseg_tpu_torch.core.visualization import imshow_det_bboxes
    from boxinstseg_tpu_torch.data.coco_api import rle_decode
    from boxinstseg_tpu_torch.registry import build_dataset

    cfg = Config.fromfile(args.config)
    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    with open(args.prediction_path) as f:
        raw = json.load(f)
    results = [dict(bboxes=np.asarray(r['bboxes'],
                                      np.float64).reshape(-1, 5),
                    labels=np.asarray(r['labels'], np.int64),
                    masks=r.get('masks')) for r in raw]

    scores = [image_score(res, dataset.get_ann_info(i),
                          score_thr=args.show_score_thr)
              for i, res in enumerate(results)]
    order = np.argsort(scores)
    groups = {'worst': order[:args.topk], 'best': order[-args.topk:][::-1]}
    for group, idxs in groups.items():
        out_dir = os.path.join(args.show_dir, group)
        os.makedirs(out_dir, exist_ok=True)
        for i in idxs:
            info = dataset.data_infos[int(i)]
            path = os.path.join(dataset.img_prefix, info['file_name'])
            img = cv2.imread(path)
            if img is None:
                continue
            res = results[int(i)]
            masks = None
            if res.get('masks'):
                masks = [rle_decode(m) if isinstance(m, dict) else
                         np.asarray(m, np.uint8) for m in res['masks']]
            imshow_det_bboxes(
                img, res['bboxes'], res['labels'], segms=masks,
                class_names=dataset.CLASSES,
                score_thr=args.show_score_thr,
                out_file=os.path.join(
                    out_dir, f'{scores[int(i)]:.3f}_'
                             f'{os.path.basename(info["file_name"])}'))
        print(f'{group}: saved {len(idxs)} to {out_dir}')
    return scores


if __name__ == '__main__':
    main()
