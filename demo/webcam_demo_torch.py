#!/usr/bin/env python
"""Webcam demo of the PyTorch / CUDA port, counterpart of
``demo/webcam_demo.py``: camera frames through ``inference_detector``,
shown live (with a display) and saved to ``--out-dir`` when given.

    python demo/webcam_demo_torch.py CONFIG CKPT [--camera-id 0] \
        [--score-thr 0.5] [--max-frames N] [--out-dir DIR] [--device cpu]

``--device`` is ``cuda`` by default (and raises without a card). ESC stops
the live view.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Webcam demo (PyTorch port)')
    p.add_argument('config')
    p.add_argument('checkpoint')
    p.add_argument('--camera-id', type=int, default=0)
    p.add_argument('--score-thr', type=float, default=0.5)
    p.add_argument('--max-frames', type=int, default=None,
                   help='stop after N frames (headless testing)')
    p.add_argument('--out-dir', default=None,
                   help='also save visualized frames here (headless)')
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config, format key=value')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    return p.parse_args(argv)


def run_capture(model, cfg, cap, score_thr=0.5, max_frames=None,
                out_dir=None, show=False):
    """Frames of the opened ``cv2.VideoCapture`` ``cap`` through
    ``inference_detector`` until it ends, ``max_frames`` or ESC (with
    ``show``); each drawn frame saved as ``out_dir/NNNNNN.jpg`` when given.
    Returns the number of frames."""
    import cv2
    from boxinstseg_tpu_torch.apis.inference import (class_names,
                                                     inference_detector)
    from boxinstseg_tpu_torch.core.visualization import imshow_det_bboxes
    names = class_names(cfg)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    n = 0
    while max_frames is None or n < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        result = inference_detector(model, cfg, frame)
        vis = imshow_det_bboxes(
            frame, result['bboxes'], result['labels'],
            segms=result['masks'], class_names=names, score_thr=score_thr,
            out_file=os.path.join(out_dir, f'{n:06d}.jpg')
            if out_dir else None)
        n += 1
        if show:
            cv2.imshow('boxinstseg_tpu_torch', vis)
            if cv2.waitKey(1) == 27:   # ESC
                break
    return n


def main(argv=None):
    args = parse_args(argv)
    import cv2
    from boxinstseg_tpu_torch.apis.inference import (init_detector,
                                                     load_config,
                                                     select_device)
    model, cfg = init_detector(load_config(args.config, args.cfg_options),
                               args.checkpoint,
                               device=select_device(args.device))
    cap = cv2.VideoCapture(args.camera_id)
    if not cap.isOpened():
        raise RuntimeError(f'cannot open camera {args.camera_id}')
    try:
        n = run_capture(model, cfg, cap, args.score_thr, args.max_frames,
                        args.out_dir, show=bool(os.environ.get('DISPLAY')))
    finally:
        cap.release()
    print(f'processed {n} frames')
    return n


if __name__ == '__main__':
    main()
