#!/usr/bin/env python
"""Animated GIF of saved results, counterpart of
``demo/create_result_gif.py``: the test set's images with the detections
of a ``tools/test_torch.py --save-results`` json drawn on them.

    python demo/create_result_gif_torch.py CONFIG results.json \
        --out result.gif [--num-images 20] [--fps 2] [--score-thr 0.3]

Host only (cv2, PIL and the port's RLE decoder): no device is used.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='GIF of saved results')
    p.add_argument('config')
    p.add_argument('results',
                   help='json from tools/test_torch.py --save-results')
    p.add_argument('--out', default='result.gif')
    p.add_argument('--num-images', type=int, default=20)
    p.add_argument('--fps', type=int, default=2)
    p.add_argument('--score-thr', type=float, default=0.3)
    return p.parse_args(argv)


def main(argv=None):
    """Write the GIF; returns the number of frames."""
    args = parse_args(argv)
    import cv2
    import numpy as np
    from PIL import Image
    from boxinstseg_tpu_torch.config import Config
    from boxinstseg_tpu_torch.core.visualization import imshow_det_bboxes
    from boxinstseg_tpu_torch.data.coco_api import rle_decode
    from boxinstseg_tpu_torch.registry import build_dataset

    cfg = Config.fromfile(args.config)
    dataset = build_dataset({**cfg.data['test'], 'test_mode': True})
    with open(args.results) as f:
        raw = json.load(f)

    frames = []
    for i, r in enumerate(raw[:args.num_images]):
        info = dataset.data_infos[i]
        img = cv2.imread(os.path.join(dataset.img_prefix,
                                      info['file_name']))
        if img is None:
            continue
        masks = None
        if r.get('masks'):
            masks = [rle_decode(m) if isinstance(m, dict) else
                     np.asarray(m, np.uint8) for m in r['masks']]
        vis = imshow_det_bboxes(
            img, np.asarray(r['bboxes'], np.float64).reshape(-1, 5),
            np.asarray(r['labels'], np.int64), segms=masks,
            class_names=dataset.CLASSES, score_thr=args.score_thr)
        frames.append(Image.fromarray(vis[..., ::-1]))  # BGR -> RGB
    if not frames:
        raise RuntimeError('no frames rendered: no image of the results '
                           'could be read')
    frames[0].save(args.out, save_all=True, append_images=frames[1:],
                   duration=int(1000 / args.fps), loop=0)
    print(f'saved {args.out} ({len(frames)} frames)')
    return len(frames)


if __name__ == '__main__':
    main()
