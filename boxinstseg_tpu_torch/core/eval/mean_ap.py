"""VOC-style mAP evaluation (reference: mmdet/core/evaluation/mean_ap.py
eval_map / tpfp_default / average_precision — same matching semantics:
score-descending greedy assignment, one TP per GT, ignore regions and
area ranges excluded from both matching credit and GT counts; 'area'
(all-point) or VOC07 '11points' AP).

Pure numpy, vectorized IoU; no process pool — the per-class work is tiny
compared to the reference's default nproc=4 fan-out."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def bbox_overlaps_np(b1: np.ndarray, b2: np.ndarray, mode: str = 'iou',
                     eps: float = 1e-6,
                     use_legacy_coordinate: bool = False) -> np.ndarray:
    """(n, 4) x (k, 4) -> (n, k) IoU/IoF, fully vectorized."""
    ext = 1.0 if use_legacy_coordinate else 0.0
    b1 = np.asarray(b1, np.float32)
    b2 = np.asarray(b2, np.float32)
    if b1.shape[0] * b2.shape[0] == 0:
        return np.zeros((b1.shape[0], b2.shape[0]), np.float32)
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:4], b2[None, :, 2:4])
    wh = np.clip(rb - lt + ext, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (b1[:, 2] - b1[:, 0] + ext) * (b1[:, 3] - b1[:, 1] + ext)
    a2 = (b2[:, 2] - b2[:, 0] + ext) * (b2[:, 3] - b2[:, 1] + ext)
    if mode == 'iou':
        union = a1[:, None] + a2[None, :] - inter
    else:
        union = np.broadcast_to(a1[:, None], inter.shape)
    return inter / np.maximum(union, eps)


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = 'area') -> float:
    """AP from a PR curve: 'area' (exact) or '11points' (VOC07)."""
    if mode == 'area':
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        mpre = np.maximum.accumulate(mpre[::-1])[::-1]
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    if mode == '11points':
        ap = 0.0
        for thr in np.arange(0, 1 + 1e-3, 0.1):
            precs = precisions[recalls >= thr]
            ap += precs.max() if precs.size else 0.0
        return float(ap / 11)
    raise ValueError(mode)


def tpfp_default(det: np.ndarray, gt: np.ndarray,
                 gt_ignore: Optional[np.ndarray] = None,
                 iou_thr: float = 0.5,
                 area_ranges: Optional[Sequence[Tuple]] = None,
                 use_legacy_coordinate: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image TP/FP flags, shape (num_scales, num_dets) each."""
    ext = 1.0 if use_legacy_coordinate else 0.0
    gt_ignore = np.zeros((0, 4), np.float32) if gt_ignore is None \
        else gt_ignore
    ignored = np.concatenate([np.zeros(len(gt), bool),
                              np.ones(len(gt_ignore), bool)])
    gt_all = np.vstack([gt.reshape(-1, 4), gt_ignore.reshape(-1, 4)])
    ranges = area_ranges if area_ranges is not None else [(None, None)]
    m = det.shape[0]
    tp = np.zeros((len(ranges), m), np.float32)
    fp = np.zeros((len(ranges), m), np.float32)

    det_areas = (det[:, 2] - det[:, 0] + ext) * \
        (det[:, 3] - det[:, 1] + ext) if m else np.zeros(0)
    if gt_all.shape[0] == 0:
        for k, (lo, hi) in enumerate(ranges):
            if lo is None:
                fp[k] = 1
            else:
                fp[k, (det_areas >= lo) & (det_areas < hi)] = 1
        return tp, fp

    ious = bbox_overlaps_np(det[:, :4], gt_all,
                            use_legacy_coordinate=use_legacy_coordinate)
    iou_max = ious.max(axis=1) if m else np.zeros(0)
    iou_arg = ious.argmax(axis=1) if m else np.zeros(0, int)
    order = np.argsort(-det[:, -1]) if m else np.zeros(0, int)
    gt_areas = (gt_all[:, 2] - gt_all[:, 0] + ext) * \
        (gt_all[:, 3] - gt_all[:, 1] + ext)
    for k, (lo, hi) in enumerate(ranges):
        covered = np.zeros(len(gt_all), bool)
        area_ignore = np.zeros(len(gt_all), bool) if lo is None \
            else (gt_areas < lo) | (gt_areas >= hi)
        for i in order:
            if iou_max[i] >= iou_thr:
                j = iou_arg[i]
                if not (ignored[j] or area_ignore[j]):
                    if not covered[j]:
                        covered[j] = True
                        tp[k, i] = 1
                    else:
                        fp[k, i] = 1
                # matched an ignored GT: neither TP nor FP
            elif lo is None or (det_areas[i] >= lo and det_areas[i] < hi):
                fp[k, i] = 1
    return tp, fp


def eval_map(det_results: List[List[np.ndarray]],
             annotations: List[Dict],
             scale_ranges: Optional[Sequence[Tuple]] = None,
             iou_thr: float = 0.5,
             dataset: Optional[str] = None,
             logger=None,
             use_legacy_coordinate: bool = False):
    """det_results[img][cls] = (n, 5) dets; annotations[img] has
    bboxes/labels (+ optional bboxes_ignore/labels_ignore).
    Returns (mean_ap, per_class_results)."""
    assert len(det_results) == len(annotations)
    num_classes = len(det_results[0])
    num_scales = len(scale_ranges) if scale_ranges else 1
    area_ranges = [(lo ** 2, hi ** 2) for lo, hi in scale_ranges] \
        if scale_ranges else None
    mode = '11points' if dataset == 'voc07' else 'area'

    results = []
    for c in range(num_classes):
        cls_dets = [r[c] for r in det_results]
        cls_gts, cls_ign = [], []
        for ann in annotations:
            sel = ann['labels'] == c
            cls_gts.append(np.asarray(ann['bboxes'])[sel].reshape(-1, 4))
            if ann.get('labels_ignore') is not None:
                isel = ann['labels_ignore'] == c
                cls_ign.append(np.asarray(
                    ann['bboxes_ignore'])[isel].reshape(-1, 4))
            else:
                cls_ign.append(np.zeros((0, 4), np.float32))
        tpfp = [tpfp_default(d, g, gi, iou_thr, area_ranges,
                             use_legacy_coordinate)
                for d, g, gi in zip(cls_dets, cls_gts, cls_ign)]

        num_gts = np.zeros(num_scales, int)
        ext = 1.0 if use_legacy_coordinate else 0.0
        for g in cls_gts:
            if area_ranges is None:
                num_gts[0] += g.shape[0]
            else:
                ga = (g[:, 2] - g[:, 0] + ext) * (g[:, 3] - g[:, 1] + ext)
                for k, (lo, hi) in enumerate(area_ranges):
                    num_gts[k] += int(np.sum((ga >= lo) & (ga < hi)))
        dets = np.vstack([d.reshape(-1, 5) for d in cls_dets])
        order = np.argsort(-dets[:, -1])
        tp = np.cumsum(np.hstack([t for t, _ in tpfp])[:, order], axis=1)
        fp = np.cumsum(np.hstack([f for _, f in tpfp])[:, order], axis=1)
        eps = np.finfo(np.float32).eps
        recalls = tp / np.maximum(num_gts[:, None], eps)
        precisions = tp / np.maximum(tp + fp, eps)
        ap = np.array([average_precision(recalls[k], precisions[k], mode)
                       for k in range(num_scales)])
        if scale_ranges is None:
            recalls, precisions, ap = recalls[0], precisions[0], ap[0]
            num_gts = int(num_gts[0])
        results.append(dict(num_gts=num_gts, num_dets=len(dets),
                            recall=recalls, precision=precisions, ap=ap))

    if scale_ranges is not None:
        all_ap = np.vstack([r['ap'] for r in results])
        all_gts = np.vstack([r['num_gts'] for r in results])
        mean_ap = [float(all_ap[all_gts[:, k] > 0, k].mean())
                   if np.any(all_gts[:, k] > 0) else 0.0
                   for k in range(num_scales)]
    else:
        aps = [r['ap'] for r in results if r['num_gts'] > 0]
        mean_ap = float(np.mean(aps)) if aps else 0.0

    print_map_summary(mean_ap, results, logger=logger)
    return mean_ap, results


def print_map_summary(mean_ap, results, class_names=None, logger=None):
    if logger == 'silent':
        return
    out = print if logger is None else logger.info
    scalar = not isinstance(mean_ap, list)
    if scalar:
        out(f'{"class":>12s} {"gts":>7s} {"dets":>7s} '
            f'{"recall":>7s} {"ap":>7s}')
        for i, r in enumerate(results):
            name = class_names[i] if class_names else str(i)
            rec = float(r['recall'][-1]) if np.size(r['recall']) else 0.0
            out(f'{name:>12s} {r["num_gts"]:>7d} {r["num_dets"]:>7d} '
                f'{rec:>7.3f} {float(r["ap"]):>7.3f}')
    out(f'mAP = {mean_ap}')
