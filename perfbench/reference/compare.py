"""The numbers that decide ``correct`` and their limits.

Train cells (each against the reference's norm of the leaf or of the
median leaf, whichever is larger, taking the worst leaf):

- ``loss_gap``: the relative gap of the first checked step's total loss
  (the later steps' losses swing from seed to seed: rounding after one or
  two updates may flip a top-k sampling of positives or a Hungarian match;
  every step's gap is printed in ``step_loss_gaps``);
- ``grad_gap``: the gap between the program's and the reference's norm of
  each leaf's first gradient as the optimizer takes it (after the clip);
- ``update_gap``: the same of each leaf's change over the checked steps.

Leaves whose first reference gradient is under a thousandth of the
median leaf's (a key's bias under softmax, a frozen stage's zero) move by
round-off alone and are left out of both leaf numbers.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

import torch

NOUGHT = 1e-3
LOSS_STEPS = 1


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    lp = torch.tensor(prog['losses'], dtype=torch.float64)
    lr = torch.tensor(ref['losses'], dtype=torch.float64)
    if lp.numel() != lr.numel() or not torch.isfinite(lp).all():
        rel = torch.full_like(lr, float('inf'))
    else:
        rel = (lp - lr).abs() / lr.abs().clamp_min(1e-12)
    loss_gap = float(rel[:LOSS_STEPS].max())
    g_ref = ref['grad1'].double()
    keep = g_ref >= NOUGHT * g_ref.median()
    out = dict(loss_gap=loss_gap)
    for key, name in (('grad1', 'grad_gap'), ('change', 'update_gap')):
        r = ref[key].double()[keep]
        p = prog[key].double()[keep]
        floor = r.median()
        gap = (p - r).abs() / torch.maximum(r, floor)
        gap = torch.where(torch.isfinite(p), gap, torch.full_like(gap, 1e9))
        out[name] = float(gap.max())
    out['step_loss_gaps'] = [float(v) for v in rel]
    out['leaves_compared'] = int(keep.sum())
    out['leaves'] = int(keep.numel())
    return out


def verdict(gaps: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every limited number is within its limit (a missing
    limit file fails)."""
    if not limits:
        return False
    return all(gaps[k] <= v for k, v in limits.items())


# the program's detections compared, by score: the first half of the
# 100 kept, so that a (query, class) pair whose score ties the 100th kept
# one within rounding, and so may be kept on one side only, is never
# among them
COMPARED_DETECTIONS = 50
# the quantile of the compared detections' gaps that is compared
QUANTILE = 0.95
# the cost of pairing detections of different labels
APART = 1e6


def box_miss(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, m) 1 - the intersection over union of xyxy boxes a (n, 4) and
    b (m, 4); 1 where both are empty."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)  # noqa
    union = area(a)[:, None] + area(b)[None, :] - inter
    return 1.0 - inter / np.maximum(union, 1e-12)


def quantile(values: np.ndarray, q: float) -> float:
    """The ``q`` quantile, linear between order statistics (numpy's
    default)."""
    return float(np.quantile(values, q)) if len(values) else 1.0


def predict_gaps(det, ref: Dict, device) -> Dict[str, float]:
    """One image's gaps. The program's first ``COMPARED_DETECTIONS``
    detections by score are matched one to one to the reference's
    detections (an exact assignment in float64, scipy's), a pair costing
    the larger of its two gaps, and ``APART`` where the labels differ; a
    detection left without a reference detection of its label reads 1 on
    both. Per detection:

    - ``mask_box_gap``: the larger of 1 - the matched masks' intersection
      over union and 1 - the matched boxes' (a Box2Mask box is its mask's
      extent, so the box adds what its derivation could break);
    - ``score_gap``: the matched scores' relative gap.

    Each number is the ``QUANTILE`` over the compared detections, so that
    a few detections altered, or duplicated where the reference has one,
    stand out, while a mask pixel whose logit lies within rounding of the
    binarising 0 moves one small mask by more than rounding (the worst
    detection's gaps are printed as ``worst_*``). Two queries can carry
    the same mask (several whole-image masks of random weights do), which
    is why the score weighs in the match."""
    from scipy.optimize import linear_sum_assignment
    boxes = np.asarray(det['bboxes'], np.float64).reshape(-1, 5)
    scores = boxes[:, 4]
    labels = np.asarray(det['labels'])
    order = np.argsort(-scores, kind='stable')[:COMPARED_DETECTIONS]
    n = len(order)
    if n == 0:
        return dict(mask_box_gap=1.0, score_gap=1.0)
    pm = torch.from_numpy(np.stack([np.asarray(det['masks'][i])
                                    for i in order])).to(device)
    pm = pm.reshape(n, -1).float()
    rm = ref['masks'].reshape(ref['masks'].shape[0], -1).float()
    inter = pm @ rm.T
    union = pm.sum(1)[:, None] + rm.sum(1)[None, :] - inter
    miss = 1.0 - (inter / union.clamp_min(1.0)).double().cpu().numpy()
    bmiss = box_miss(boxes[order, :4], np.asarray(ref['boxes'], np.float64))
    shape = np.maximum(miss, bmiss)
    s_r = np.asarray(ref['scores'], np.float64)[None, :]
    srel = np.abs(scores[order][:, None] - s_r) / np.maximum(np.abs(s_r),
                                                             1e-12)
    same = labels[order][:, None] == np.asarray(ref['labels'])[None, :]
    cost = np.where(same, np.maximum(shape, srel), APART)
    rows, cols = linear_sum_assignment(cost)
    hit = np.zeros(n, bool)
    col = np.zeros(n, np.int64)
    hit[rows] = same[rows, cols]
    col[rows] = cols
    rows = np.arange(n)
    gaps = {}
    # the box's own gap alone is printed, not compared: it reads 0 on sound
    # runs and in the control alike, so it is compared within mask_box_gap
    for name, g in (('mask_box_gap', shape), ('score_gap', srel),
                    ('box_gap', bmiss)):
        per = np.where(hit, g[rows, col], 1.0) if g.size else np.ones(n)
        if name != 'box_gap':
            gaps[name] = quantile(per, QUANTILE)
        gaps['worst_' + name] = float(per.max())
    return gaps
