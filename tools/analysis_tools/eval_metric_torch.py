#!/usr/bin/env python
"""Re-evaluate saved results, the PyTorch port's copy of
``tools/analysis_tools/eval_metric.py`` (reference surface:
tools/analysis_tools/eval_metric.py). Results are the json that
tools/test_torch.py --save-results writes; host only."""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('results', help='json results file from '
                                      'tools/test_torch.py')
    p.add_argument('--eval', nargs='+', default=['bbox', 'segm'])
    args = p.parse_args(argv)

    import numpy as np
    from boxinstseg_tpu_torch.config import Config
    from boxinstseg_tpu_torch.registry import build_dataset

    cfg = Config.fromfile(args.config)
    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    with open(args.results) as f:
        raw = json.load(f)
    results = []
    for r in raw:
        results.append(dict(
            bboxes=np.asarray(r['bboxes'], np.float64).reshape(-1, 5),
            labels=np.asarray(r['labels'], np.int64),
            masks=r.get('masks')))
    metrics = dataset.evaluate(results, metric=args.eval)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == '__main__':
    main()
