"""The one traffic generator: it reads a mix's parameters from
``perfbench/traffic/<name>.json`` and draws the cell's samples from the
seed.

Every seed gets the same plan of shapes (orientation, scale, instance
count of each image, the pairing of images into batches), built from
fixed quantiles of the mix's distributions; the seed permutes the plan and
draws the content: the colour blocks, the boxes' places and sizes and the
labels. So two seeds run the same work in another order.

Kinds of mix:

- ``train_boxes``: batches of ``batch`` training samples as the train
  pipeline leaves them (normalised RGB, boxes, labels, and for a config
  with ``with_gt_masks`` the box bitmasks), each image a keep-ratio resize
  of a COCO-sized original to one of ``shorts`` (``resize: "fit"``, long
  side at most ``long``) or a large-scale-jitter crop (``resize: "lsj"``:
  scale uniform in ``scale_range`` times ``crop``, cropped to ``crop``);
- ``predict_images``: single test images, a keep-ratio resize of a
  COCO-sized original to fit ``long`` x ``short``.

Images are flat ``block`` x ``block`` colour blocks with a solid-colour
rectangle for each instance, so the colour-similarity gates open inside
boxes and on flat ground.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, 'traffic', f'{name}.json')) as f:
        return json.load(f)


def quantile_counts(n: int, dist: dict) -> List[int]:
    """``n`` instance counts at the mid quantiles of a log-normal
    (``mu``, ``sigma``) clipped to [``min``, ``max``]: the same multiset for
    every seed."""
    from statistics import NormalDist
    nd = NormalDist(dist['mu'], dist['sigma'])
    out = [int(round(math.exp(nd.inv_cdf((i + 0.5) / n)))) for i in range(n)]
    return [min(max(v, dist['min']), dist['max']) for v in out]


def _normalise(rgb: np.ndarray, norm: dict) -> np.ndarray:
    mean = np.asarray(norm['mean'], np.float32)
    std = np.asarray(norm['std'], np.float32)
    return (rgb.astype(np.float32) - mean) / std


def draw_image(rng, h: int, w: int, n: int, mix: dict):
    """(uint8 RGB (h, w, 3), int boxes (n, 4) xyxy) of flat colour blocks
    with a solid rectangle per instance, sides log-uniform from
    ``box_min`` (or a quarter of the side, if less) to ``box_max_frac`` of
    the side."""
    b = mix['block']
    blocks = rng.integers(0, 256, (h // b + 1, w // b + 1, 3))
    img = np.repeat(np.repeat(blocks, b, 0), b, 1)[:h, :w].astype(np.uint8)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        sides = []
        for dim in (w, h):
            lo = min(float(mix['box_min']), dim / 4.0)
            hi = max(lo + 1.0, dim * mix['box_max_frac'])
            sides.append(int(math.exp(rng.uniform(math.log(lo),
                                                  math.log(hi)))))
        bw, bh = max(sides[0], 2), max(sides[1], 2)
        x1 = int(rng.integers(0, max(w - bw, 0) + 1))
        y1 = int(rng.integers(0, max(h - bh, 0) + 1))
        x2, y2 = min(x1 + bw, w), min(y1 + bh, h)
        boxes[i] = (x1, y1, x2, y2)
        img[y1:y2, x1:x2] = rng.integers(0, 256, 3)
    return img, boxes


def _content_shape(mix: dict, landscape: bool, scale: float, index: int):
    """(h, w) of a training image's content and (oh, ow) of its original."""
    oh, ow = mix['originals'][index % len(mix['originals'])]
    if not landscape:
        oh, ow = ow, oh
    if mix['resize'] == 'fit':
        r = min(mix['long'] / max(oh, ow), scale / min(oh, ow))
        return (int(round(oh * r)), int(round(ow * r))), (oh, ow)
    crop = mix['crop']
    r = scale * crop / max(oh, ow)
    return (min(int(round(oh * r)), crop), min(int(round(ow * r)), crop)), \
        (oh, ow)


def train_plan(mix: dict) -> List[dict]:
    """The seed-free plan: one dict per batch with its orientation and each
    image's scale and instance count."""
    nb, bsz = mix['pool_batches'], mix['batch']
    n_land = int(round(nb * mix['landscape_share']))
    counts = sorted(quantile_counts(nb * bsz, mix['instances']))
    if mix['resize'] == 'fit':
        scales = [mix['shorts'][i % len(mix['shorts'])]
                  for i in range(nb * bsz)]
    else:
        lo, hi = mix['scale_range']
        scales = [lo + (hi - lo) * (i + 0.5) / (nb * bsz)
                  for i in range(nb * bsz)]
    # pair the i-th smallest count with the i-th largest of the other half,
    # so batches span the GT buckets alike on every seed
    half = nb * bsz // 2
    order = [v for pair in zip(range(half), range(nb * bsz - 1, half - 1, -1))
             for v in pair]
    spread = np.random.default_rng(0).permutation(nb * bsz)
    # the portrait batches spread evenly over the plan's GT counts
    portrait = set(np.linspace(nb - 1, 0, nb - n_land, endpoint=False)
                   .round().astype(int).tolist()) if n_land < nb else set()
    plan = []
    for j in range(nb):
        idx = order[j * bsz:(j + 1) * bsz]
        plan.append(dict(landscape=j not in portrait,
                         counts=[counts[i] for i in idx],
                         scales=[scales[spread[i]] for i in idx],
                         originals=[i for i in idx]))
    return plan


def train_samples(mix: dict, seed: int, norm: dict, num_classes: int,
                  with_masks: bool) -> List[List[Dict]]:
    """The pool: ``pool_batches`` lists of ``batch`` samples, the plan's
    batches in an order drawn from the seed, each sample drawn from it."""
    rng = np.random.default_rng(int(seed))
    plan = train_plan(mix)
    perm = rng.permutation(len(plan))
    pool = []
    for j in perm:
        p = plan[j]
        batch = []
        for n, scale, orig in zip(p['counts'], p['scales'],
                                  p['originals']):
            (h, w), (oh, ow) = _content_shape(mix, p['landscape'], scale,
                                              orig)
            img, boxes = draw_image(rng, h, w, n, mix)
            smp = dict(img=_normalise(img, norm), ori_shape=(oh, ow, 3),
                       img_shape=(h, w, 3), gt_bboxes=boxes,
                       gt_labels=rng.integers(0, num_classes, n)
                       .astype(np.int64))
            if with_masks:
                m = np.zeros((n, h, w), np.uint8)
                for i, (x1, y1, x2, y2) in enumerate(boxes.astype(int)):
                    m[i, y1:y2, x1:x2] = 1
                smp['gt_masks'] = m
            batch.append(smp)
        pool.append(batch)
    return pool


def predict_images(mix: dict, seed: int, norm: dict) -> List[Dict]:
    """The pool of test images: ``pool_images`` keep-ratio resizes of
    COCO-sized originals to fit ``long`` x ``short``, landscape and
    portrait in the mix's share, in an order drawn from the seed."""
    rng = np.random.default_rng(int(seed))
    n = mix['pool_images']
    n_land = int(round(n * mix['landscape_share']))
    out = []
    for j in rng.permutation(n):
        oh, ow = mix['originals'][j % len(mix['originals'])]
        if j >= n_land:
            oh, ow = ow, oh
        r = min(mix['long'] / max(oh, ow), mix['short'] / min(oh, ow))
        h, w = int(round(oh * r)), int(round(ow * r))
        img, _ = draw_image(rng, h, w, 0, mix)
        out.append(dict(img=_normalise(img, norm), img_shape=(h, w, 3),
                        ori_shape=(oh, ow, 3),
                        scale_factor=np.array([w / ow, h / oh, w / ow,
                                               h / oh], np.float32)))
    return out
