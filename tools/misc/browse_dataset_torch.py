#!/usr/bin/env python
"""Draw ground-truth annotations after the training pipeline with the
PyTorch port's data layer, the counterpart of
``tools/misc/browse_dataset.py`` (reference: tools/misc/browse_dataset.py;
saves to --output-dir instead of a GUI). Host only."""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))


def main(argv=None):
    p = argparse.ArgumentParser(description='Browse a dataset')
    p.add_argument('config')
    p.add_argument('--output-dir', default='work_dirs/browse_dataset')
    p.add_argument('--dataset', default='train',
                   choices=['train', 'val', 'test'])
    p.add_argument('--number', type=int, default=20,
                   help='how many samples to render')
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)

    from boxinstseg_tpu_torch.config import (Config, compat_cfg,
                                             replace_cfg_vals)
    from boxinstseg_tpu_torch.registry import build_dataset
    from boxinstseg_tpu_torch.core.visualization import imshow_det_bboxes

    cfg = compat_cfg(replace_cfg_vals(Config.fromfile(args.config)))
    dataset = build_dataset(cfg.data[args.dataset])
    classes = getattr(dataset, 'CLASSES', None)
    os.makedirs(args.output_dir, exist_ok=True)
    rng = np.random.RandomState(args.seed)

    n = min(args.number, len(dataset))
    for idx in range(n):
        results = dataset.prepare(idx, rng=rng)
        if results is None:
            continue
        img = results['img']
        # un-normalize back to displayable uint8 if the pipeline normalized
        norm = results.get('img_norm_cfg')
        if norm is not None:
            img = img * norm['std'] + norm['mean']
            if norm['to_rgb']:
                img = img[..., ::-1]
        img = np.clip(img, 0, 255).astype(np.uint8)
        bboxes = results.get('gt_bboxes', np.zeros((0, 4), np.float32))
        labels = results.get('gt_labels', np.zeros((0,), np.int64))
        masks = results.get('gt_masks')
        if masks is not None and hasattr(masks, 'to_ndarray'):
            masks = masks.to_ndarray().astype(bool)
        name = results.get('img_info', {}).get('file_name', f'{idx}.jpg')
        out = os.path.join(args.output_dir,
                           os.path.basename(str(name)))
        imshow_det_bboxes(img, np.asarray(bboxes), np.asarray(labels),
                          segms=masks, class_names=classes,
                          out_file=out)
        print(f'[{idx + 1}/{n}] -> {out}')
    return n


if __name__ == '__main__':
    main()
