#!/usr/bin/env python
"""Single-image demo of the PyTorch / CUDA port (``boxinstseg_tpu_torch``),
counterpart of ``demo/image_demo.py``: image + config + checkpoint -> the
drawn detections.

    python demo/image_demo_torch.py demo.jpg \
        configs/boxinst/boxinst_r50_fpn_1x_coco.py iter_90000.pth \
        --out-file demo_out.jpg [--device cpu]

``--device`` is ``cuda`` by default (and raises without a card); ``cpu``
runs only when asked for. The checkpoint is a ``.pth`` (the port's own or
an mmdet one); the class names are the config's test dataset's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Image demo (PyTorch port)')
    p.add_argument('img', help='image file')
    p.add_argument('config', help='config file')
    p.add_argument('checkpoint', help='.pth checkpoint')
    p.add_argument('--out-file', default='demo_out.jpg')
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config, format key=value')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    return p.parse_args(argv)


def main(argv=None):
    """Draw the detections into ``--out-file``; returns the result (an
    ``InstanceData`` with bboxes, labels and masks)."""
    args = parse_args(argv)
    import cv2
    from boxinstseg_tpu_torch.apis.inference import (class_names,
                                                     inference_detector,
                                                     init_detector,
                                                     load_config,
                                                     select_device)
    from boxinstseg_tpu_torch.core.visualization import imshow_det_bboxes

    model, cfg = init_detector(load_config(args.config, args.cfg_options),
                               args.checkpoint,
                               device=select_device(args.device))
    result = inference_detector(model, cfg, args.img)
    imshow_det_bboxes(cv2.imread(args.img), result['bboxes'],
                      result['labels'], segms=result['masks'],
                      class_names=class_names(cfg),
                      score_thr=args.score_thr, out_file=args.out_file)
    print(f'saved to {args.out_file} ({len(result["bboxes"])} detections)')
    return result


if __name__ == '__main__':
    main()
