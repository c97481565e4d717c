#!/usr/bin/env python
"""Video demo of the PyTorch / CUDA port, counterpart of
``demo/video_demo.py``: each frame through ``inference_detector`` (batch
1), drawn and written to an annotated video.

    python demo/video_demo_torch.py in.mp4 CONFIG CKPT --out out.mp4 \
        [--score-thr 0.3] [--max-frames N] [--device cpu]

The output's codec follows its extension: MJPG for ``.avi``, mp4v else.
``--device`` is ``cuda`` by default (and raises without a card).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Video demo (PyTorch port)')
    p.add_argument('video')
    p.add_argument('config')
    p.add_argument('checkpoint')
    p.add_argument('--out', default='video_out.mp4')
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--max-frames', type=int, default=None)
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config, format key=value')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    return p.parse_args(argv)


def detect_video(model, cfg, cap, score_thr=0.3, max_frames=None, out=None):
    """Every frame of the opened ``cv2.VideoCapture`` ``cap`` (at most
    ``max_frames``) through ``inference_detector``, drawn; the drawn frames
    go to the video ``out`` when given. Returns the per-frame results."""
    import cv2
    from boxinstseg_tpu_torch.apis.inference import (class_names,
                                                     inference_detector)
    from boxinstseg_tpu_torch.core.visualization import (imshow_det_bboxes,
                                                         open_video_writer)
    names = class_names(cfg)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    writer, results = None, []
    try:
        while max_frames is None or len(results) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            result = inference_detector(model, cfg, frame)
            vis = imshow_det_bboxes(frame, result['bboxes'],
                                    result['labels'], segms=result['masks'],
                                    class_names=names, score_thr=score_thr)
            if out:
                writer = writer or open_video_writer(out, fps, vis.shape)
                writer.write(vis)
            results.append(result)
    finally:
        if writer is not None:
            writer.release()
    return results


def main(argv=None):
    """Write the annotated video; returns (per-frame results, frames/s of
    the whole loop: decoding, predict, drawing and encoding)."""
    args = parse_args(argv)
    import cv2
    from boxinstseg_tpu_torch.apis.inference import (init_detector,
                                                     load_config,
                                                     select_device)
    model, cfg = init_detector(load_config(args.config, args.cfg_options),
                               args.checkpoint,
                               device=select_device(args.device))
    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        raise RuntimeError(f'cannot open {args.video}')
    t0 = time.perf_counter()
    try:
        results = detect_video(model, cfg, cap, args.score_thr,
                               args.max_frames, args.out)
    finally:
        cap.release()
    rate = len(results) / max(time.perf_counter() - t0, 1e-9)
    print(f'wrote {len(results)} frames to {args.out} ({rate:.3f} frames/s)')
    return results, rate


if __name__ == '__main__':
    main()
