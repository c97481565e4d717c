"""The port's demos and result drawing, on the CPU.

- ``core.visualization.imshow_det_bboxes`` byte for byte against the JAX
  package's on seeded images, boxes, labels and masks (its copy);
- ``demo/image_demo_torch.py`` on an image of the evaluation set of
  ``tests/test_torch_eval.py`` (its tiny CondInst's checkpoint): the drawn
  file is written at the image's size and the detections are
  ``inference_detector``'s;
- ``demo/video_demo_torch.py`` (batch 1) and
  ``demo/video_accel_demo_torch.py`` (batch 3: the last batch padded)
  over a 4-frame MJPG ``.avi`` of those images agree frame by frame:
  labels exactly, boxes within 1e-3 px, masks exactly; both write their
  video;
- ``demo/webcam_demo_torch.py``'s frame loop on that file saves a drawn
  frame a frame;
- ``demo/create_result_gif_torch.py`` draws a ``--save-results`` json into
  a GIF of one frame an image.
"""
import json
import os

import cv2
import numpy as np
import pytest
import torch

import test_torch_threads  # noqa: F401  (one torch thread)

from boxinstseg_tpu.core.visualization import \
    imshow_det_bboxes as j_imshow
from test_torch_eval import eval_set  # noqa: F401  (fixture)
from test_torch_tools import load_tool

from boxinstseg_tpu_torch.apis.inference import (inference_detector,
                                                 init_detector)
from boxinstseg_tpu_torch.apis.test import run_evaluation
from boxinstseg_tpu_torch.config import Config
from boxinstseg_tpu_torch.core.visualization import imshow_det_bboxes
from boxinstseg_tpu_torch.registry import build_dataset

BOX_ATOL = 1e-3          # pixels, frame by frame between the two demos
FRAMES = 4


def seeded_detections(seed, n=6, h=90, w=120):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
    xy = rng.uniform(0, [w - 30, h - 30], (n, 2))
    wh = rng.uniform(8, 30, (n, 2))
    bboxes = np.concatenate([xy, xy + wh, rng.rand(n, 1)], 1)
    labels = rng.randint(0, 5, n)
    masks = [(rng.rand(h, w) > 0.7).astype(np.uint8) for _ in range(n)]
    return img, bboxes, labels, masks


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('score_thr', [0.0, 0.5])
def test_imshow_det_bboxes_matches_jax_bytes(seed, score_thr, tmp_path):
    img, bboxes, labels, masks = seeded_detections(seed)
    names = ('a', 'b', 'c')                       # labels 3, 4: 'cls n'
    got = imshow_det_bboxes(img, bboxes, labels, segms=masks,
                            class_names=names, score_thr=score_thr,
                            out_file=str(tmp_path / 'got.png'))
    want = j_imshow(img, bboxes, labels, segms=masks, class_names=names,
                    score_thr=score_thr, out_file=str(tmp_path / 'want.png'))
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got, img)
    assert (tmp_path / 'got.png').read_bytes() == \
        (tmp_path / 'want.png').read_bytes()
    # no detections: the image back unchanged
    empty = imshow_det_bboxes(img, np.zeros((0, 5)), np.zeros(0, int))
    assert empty.tobytes() == img.tobytes()


@pytest.fixture(scope='module')
def demo_files(eval_set, tmp_path_factory):  # noqa: F811
    """(config file, checkpoint, image paths, 4-frame .avi) of the
    evaluation set."""
    tm, _, _, cd = eval_set
    root = tmp_path_factory.mktemp('demo')
    ckpt = str(root / 'model.pth')
    torch.save({'state_dict': tm.state_dict()}, ckpt)
    cfg_file = root / 'cfg.py'
    cfg_file.write_text('\n'.join(f'{k} = {v!r}' for k, v in cd.items()))
    img_dir = cd['data']['test']['img_prefix']
    images = [os.path.join(img_dir, f'{i}.png') for i in range(FRAMES)]
    video = str(root / 'frames.avi')
    first = cv2.imread(images[0])
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*'MJPG'), 5,
                             (first.shape[1], first.shape[0]))
    for path in images:
        writer.write(cv2.imread(path))
    writer.release()
    return str(cfg_file), ckpt, images, video


def test_image_demo_writes_the_drawn_image(demo_files, tmp_path):
    cfg_file, ckpt, images, _ = demo_files
    out = str(tmp_path / 'out.jpg')
    result = load_tool('demo/image_demo_torch.py').main([
        images[1], cfg_file, ckpt, '--out-file', out, '--score-thr', '0.0',
        '--device', 'cpu'])
    drawn = cv2.imread(out)
    assert drawn.shape == cv2.imread(images[1]).shape
    model, cfg = init_detector(cfg_file, ckpt, device='cpu')
    want = inference_detector(model, cfg, images[1])
    assert len(result['bboxes']) == len(want['bboxes']) >= 10
    np.testing.assert_array_equal(result['labels'], want['labels'])
    np.testing.assert_allclose(result['bboxes'], want['bboxes'], atol=1e-6)


def test_video_demos_agree_frame_by_frame(demo_files, tmp_path):
    cfg_file, ckpt, _, video = demo_files
    plain, plain_rate = load_tool('demo/video_demo_torch.py').main([
        video, cfg_file, ckpt, '--out', str(tmp_path / 'plain.avi'),
        '--device', 'cpu'])
    accel, accel_rate = load_tool('demo/video_accel_demo_torch.py').main([
        video, cfg_file, ckpt, '--out', str(tmp_path / 'accel.avi'),
        '--batch', '3', '--device', 'cpu'])
    assert len(plain) == len(accel) == FRAMES
    assert plain_rate > 0 and accel_rate > 0
    for a, b in zip(plain, accel):
        assert len(a['labels']) >= 10
        np.testing.assert_array_equal(a['labels'], b['labels'])
        np.testing.assert_allclose(a['bboxes'], b['bboxes'], atol=BOX_ATOL,
                                   rtol=0)
        assert len(a['masks']) == len(b['masks'])
        for ma, mb in zip(a['masks'], b['masks']):
            np.testing.assert_array_equal(ma, mb)
    for name in ('plain.avi', 'accel.avi'):
        cap = cv2.VideoCapture(str(tmp_path / name))
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        assert n == FRAMES, name


def test_webcam_loop_saves_a_drawn_frame_a_frame(demo_files, tmp_path):
    cfg_file, ckpt, _, video = demo_files
    webcam = load_tool('demo/webcam_demo_torch.py')
    model, cfg = init_detector(cfg_file, ckpt, device='cpu')
    cap = cv2.VideoCapture(video)
    try:
        n = webcam.run_capture(model, cfg, cap, score_thr=0.0,
                               max_frames=3, out_dir=str(tmp_path / 'out'))
    finally:
        cap.release()
    assert n == 3
    assert sorted(os.listdir(tmp_path / 'out')) == [
        f'{i:06d}.jpg' for i in range(3)]


def test_result_gif_from_saved_results(
        eval_set, demo_files, tmp_path):  # noqa: F811
    tm, _, _, cd = eval_set
    cfg_file = demo_files[0]
    cfg = Config.fromdict(cd)
    saved = str(tmp_path / 'results.json')
    run_evaluation(tm, build_dataset({**cfg.data['test'], 'test_mode': True}),
                   cfg, metrics=['bbox'], save_results=saved)
    with open(saved) as f:
        assert len(json.load(f)) == FRAMES
    gif = str(tmp_path / 'result.gif')
    n = load_tool('demo/create_result_gif_torch.py').main([
        cfg_file, saved, '--out', gif, '--score-thr', '0.0'])
    from PIL import Image
    with Image.open(gif) as im:
        assert im.n_frames == n == FRAMES
