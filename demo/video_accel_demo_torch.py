#!/usr/bin/env python
"""Batched video demo of the PyTorch / CUDA port, counterpart of
``demo/video_accel_demo.py``: a decode thread reads frames, runs the test
pipeline and batches them into a bounded queue, while fixed-size batches
go through ``apis.test.predict_batch`` on the card, so decoding overlaps
the device. A batch's image, img_shape and scale_factor are pinned on the
decode thread and copied to the card without blocking; the last batch is
padded with its last frame, so every call has one shape. Decoding stays on
the host (no NVDEC, as in the JAX demo).

    python demo/video_accel_demo_torch.py in.mp4 CONFIG CKPT --batch 4 \
        --out out.mp4 [--score-thr 0.3] [--max-frames N] [--device cpu]

``--device`` is ``cuda`` by default (and raises without a card).
"""
import argparse
import os
import queue
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

QUEUE_BATCHES = 4        # batches decoded ahead of the device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='Batched video demo (PyTorch port)')
    p.add_argument('video')
    p.add_argument('config')
    p.add_argument('checkpoint')
    p.add_argument('--out', default='video_out.mp4')
    p.add_argument('--batch', type=int, default=4,
                   help='frames per predict call')
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--max-frames', type=int, default=None)
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config, format key=value')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    return p.parse_args(argv)


def _decode(cap, pipeline, batcher, batch, max_frames, pin, out_q, stop):
    """The decode thread: (frames, host batch) items of ``batch`` frames,
    then None; an exception is passed on as the item."""
    import numpy as np
    import torch

    def put(item):
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def flush(frames, samples):
        samples = samples + [samples[-1]] * (batch - len(samples))
        host = batcher(samples)
        for k in ('image', 'img_shape', 'scale_factor'):
            t = torch.from_numpy(np.ascontiguousarray(host[k]))
            host[k] = t.pin_memory() if pin else t
        put((frames, host))

    try:
        frames, samples, n = [], [], 0
        while max_frames is None or n < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
            samples.append(pipeline({'img': frame, 'filename': None,
                                     'bbox_fields': [], 'mask_fields': []}))
            n += 1
            if len(frames) == batch:
                flush(frames, samples)
                frames, samples = [], []
        if frames:
            flush(frames, samples)
        put(None)
    except Exception as e:        # handed to the consumer, which raises it
        put(e)


def detect_video_batched(model, cfg, cap, batch=4, score_thr=0.3,
                         max_frames=None, out=None):
    """Every frame of the opened ``cv2.VideoCapture`` ``cap`` (at most
    ``max_frames``), ``batch`` frames a ``predict_batch`` call on the
    model's device while the decode thread prepares the next batches;
    drawn frames go to the video ``out`` when given. Returns the per-frame
    results, as ``inference_detector`` gives them."""
    import cv2
    from boxinstseg_tpu_torch.apis.inference import class_names
    from boxinstseg_tpu_torch.apis.test import (eval_batcher,
                                                format_detection,
                                                predict_batch)
    from boxinstseg_tpu_torch.apis.train import apply_precision_policy
    from boxinstseg_tpu_torch.core.visualization import (imshow_det_bboxes,
                                                         open_video_writer)
    from boxinstseg_tpu_torch.data.pipelines import Compose

    pipeline = Compose(list(cfg.get('test_pipeline')
                            or cfg.data['test']['pipeline']))
    device = next(model.parameters()).device
    test_cfg = dict(cfg.model.get('test_cfg', {}) or {})
    names = class_names(cfg)
    bf16 = apply_precision_policy(cfg)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    items: 'queue.Queue' = queue.Queue(maxsize=QUEUE_BATCHES)
    stop = threading.Event()
    decoder = threading.Thread(
        target=_decode, daemon=True,
        args=(cap, pipeline, eval_batcher(cfg), batch, max_frames,
              device.type == 'cuda', items, stop))
    decoder.start()
    model.eval()
    writer, results = None, []
    try:
        while True:
            item = items.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            frames, host = item
            out_dev = predict_batch(model, host, bf16)
            for i, frame in enumerate(frames):
                det = format_detection(out_dev, i, host['img_shape'][i],
                                       host['ori_shape'][i], test_cfg)
                vis = imshow_det_bboxes(frame, det['bboxes'], det['labels'],
                                        segms=det['masks'],
                                        class_names=names,
                                        score_thr=score_thr)
                if out:
                    writer = writer or open_video_writer(out, fps, vis.shape)
                    writer.write(vis)
                results.append(det)
    finally:
        stop.set()
        decoder.join(timeout=60)
        if writer is not None:
            writer.release()
    return results


def main(argv=None):
    """Write the annotated video; returns (per-frame results, frames/s of
    the whole loop)."""
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
        results = detect_video_batched(model, cfg, cap, args.batch,
                                       args.score_thr, args.max_frames,
                                       args.out)
    finally:
        cap.release()
    rate = len(results) / max(time.perf_counter() - t0, 1e-9)
    print(f'wrote {len(results)} frames to {args.out} ({rate:.3f} frames/s, '
          f'batch {args.batch})')
    return results, rate


if __name__ == '__main__':
    main()
