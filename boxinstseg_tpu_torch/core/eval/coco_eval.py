"""COCO-style detection/segmentation mAP evaluation, dependency-free.

pycocotools is not available in this environment, so this reimplements the
COCOeval protocol (the oracle the reference relies on via
CocoDataset.evaluate -> pycocotools COCOeval, reference:
mmdet/datasets/coco.py:386-649): greedy score-ordered matching per
(image, category) at 10 IoU thresholds, crowd/ignore semantics, area
ranges, 101-point interpolated precision, and the standard 12-metric
summary.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...data.coco_api import COCO, ann_to_mask, bbox_iou_xywh, mask_iou, \
    rle_decode

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


class COCOEvaluator:
    def __init__(self, coco_gt: COCO, img_ids: Sequence[int],
                 cat_ids: Sequence[int], iou_type: str = 'bbox',
                 iou_thrs=None):
        self.coco = coco_gt
        self.img_ids = list(img_ids)
        self.cat_ids = list(cat_ids)
        self.iou_type = iou_type
        # custom thresholds for error-analysis tooling
        self.iou_thrs = np.asarray(iou_thrs, np.float64) \
            if iou_thrs is not None else IOU_THRS
        self._gts = defaultdict(list)
        for img_id in self.img_ids:
            for ann in self.coco.img_to_anns.get(img_id, []):
                if ann['category_id'] in set(cat_ids):
                    self._gts[(img_id, ann['category_id'])].append(ann)

    # ------------------------------------------------------------------ eval
    def evaluate(self, detections: Dict[int, Dict[int, dict]]) -> Dict:
        """detections[img_id][cat_id] = dict(bboxes (n,4 xywh), scores (n,),
        masks: optional list of RLE dicts or binary arrays)."""
        eval_imgs = {}
        for img_id in self.img_ids:
            img_info = self.coco.imgs[img_id]
            for cat_id in self.cat_ids:
                e = self._evaluate_img(img_id, cat_id,
                                       detections.get(img_id, {}).get(
                                           cat_id), img_info)
                if e is not None:
                    eval_imgs[(img_id, cat_id)] = e
        return self._accumulate(eval_imgs)

    def _iou(self, dt, gt, img_info):
        iscrowd = [g.get('iscrowd', 0) for g in gt]
        if self.iou_type == 'bbox':
            g_boxes = np.asarray([g['bbox'] for g in gt], np.float64)
            d_boxes = np.asarray(dt['bboxes'], np.float64)
            return bbox_iou_xywh(d_boxes, g_boxes, iscrowd)
        h, w = img_info['height'], img_info['width']
        g_masks = [ann_to_mask(g, h, w) for g in gt]
        d_masks = [m if isinstance(m, np.ndarray) else rle_decode(m)
                   for m in dt['masks']]
        return mask_iou(d_masks, g_masks, iscrowd)

    def _evaluate_img(self, img_id, cat_id, dt: Optional[dict], img_info):
        gt = self._gts.get((img_id, cat_id), [])
        has_dt = dt is not None and len(dt.get('scores', [])) > 0
        if not gt and not has_dt:
            return None
        if not has_dt:
            dt = dict(bboxes=np.zeros((0, 4)), scores=np.zeros((0,)),
                      masks=[])

        scores = np.asarray(dt['scores'], np.float64)
        order = np.argsort(-scores, kind='mergesort')[:max(MAX_DETS)]
        scores = scores[order]
        dt_sorted = dict(
            bboxes=np.asarray(dt['bboxes'])[order]
            if len(dt['bboxes']) else np.zeros((0, 4)),
            masks=[dt['masks'][i] for i in order] if dt.get('masks') else [],
        )
        nd = len(scores)

        g_ignore_base = np.array(
            [bool(g.get('iscrowd', 0)) or bool(g.get('ignore', 0))
             for g in gt], bool)
        g_areas = np.array([g.get('area', g['bbox'][2] * g['bbox'][3])
                            for g in gt], np.float64)
        iscrowd_base = np.array([bool(g.get('iscrowd', 0)) for g in gt],
                                bool)
        # ious computed once in annotation order; columns permuted per
        # area range below (pycocotools computeIoU/evaluateImg split)
        ious_base = self._iou({'bboxes': dt_sorted['bboxes'],
                               'masks': dt_sorted['masks']},
                              gt, img_info) if gt else np.zeros((nd, 0))

        if self.iou_type == 'bbox':
            d_areas = (dt_sorted['bboxes'][:, 2] *
                       dt_sorted['bboxes'][:, 3]) if nd else np.zeros(0)
        else:
            d_areas = np.array(
                [(m if isinstance(m, np.ndarray) else rle_decode(m)).sum()
                 for m in dt_sorted['masks']], np.float64) if nd \
                else np.zeros(0)

        out = {}
        T = len(self.iou_thrs)
        for aname, (amin, amax) in AREA_RNG.items():
            # fold the area-range filter into the ignore flag, then sort
            # gts ignore-last PER AREA RANGE (stable) — matching order and
            # the break condition below depend on this order
            # (pycocotools evaluateImg sorts by '_ignore' per call)
            g_ig_all = g_ignore_base | (g_areas < amin) | (g_areas > amax)
            g_order = np.argsort(g_ig_all, kind='mergesort')
            g_ignore = g_ig_all[g_order]
            iscrowd = iscrowd_base[g_order]
            ious = ious_base[:, g_order] if ious_base.size else ious_base
            ng = len(gt)
            dt_m = np.zeros((T, nd), np.int64) - 1   # matched gt index
            dt_ig = np.zeros((T, nd), bool)
            gt_m = np.zeros((T, ng), np.int64) - 1
            for t_i, t in enumerate(self.iou_thrs):
                for d_i in range(nd):
                    best = -1
                    best_iou = min(t, 1 - 1e-10)
                    for g_i in range(ng):
                        if gt_m[t_i, g_i] >= 0 and not iscrowd[g_i]:
                            continue
                        # stop at ignored gts once a real match is found
                        if best >= 0 and not g_ignore[best] \
                                and g_ignore[g_i]:
                            break
                        if ious[d_i, g_i] < best_iou:
                            continue
                        best_iou = ious[d_i, g_i]
                        best = g_i
                    if best == -1:
                        continue
                    dt_m[t_i, d_i] = best
                    dt_ig[t_i, d_i] = g_ignore[best]
                    gt_m[t_i, best] = d_i
            # unmatched dts outside the area range are ignored
            d_out = (d_areas < amin) | (d_areas > amax)
            dt_ig = dt_ig | ((dt_m == -1) & d_out[None, :])
            out[aname] = dict(
                scores=scores, dt_matched=dt_m >= 0, dt_ignore=dt_ig,
                num_gt=int((~g_ignore).sum()))
        return out

    def _accumulate(self, eval_imgs) -> Dict:
        T = len(self.iou_thrs)
        K = len(self.cat_ids)
        A = len(AREA_RNG)
        M = len(MAX_DETS)
        precision = -np.ones((T, len(REC_THRS), K, A, M))
        recall = -np.ones((T, K, A, M))

        for k_i, cat_id in enumerate(self.cat_ids):
            per_img = [eval_imgs[(i, cat_id)] for i in self.img_ids
                       if (i, cat_id) in eval_imgs]
            if not per_img:
                continue
            for a_i, aname in enumerate(AREA_RNG):
                num_gt = sum(e[aname]['num_gt'] for e in per_img)
                if num_gt == 0:
                    continue
                for m_i, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate(
                        [e[aname]['scores'][:max_det] for e in per_img])
                    matched = np.concatenate(
                        [e[aname]['dt_matched'][:, :max_det]
                         for e in per_img], axis=1)
                    ignored = np.concatenate(
                        [e[aname]['dt_ignore'][:, :max_det]
                         for e in per_img], axis=1)
                    order = np.argsort(-scores, kind='mergesort')
                    matched = matched[:, order]
                    ignored = ignored[:, order]
                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t_i in range(T):
                        tp = tp_cum[t_i]
                        fp = fp_cum[t_i]
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, 1e-12)
                        recall[t_i, k_i, a_i, m_i] = rc[-1] if len(rc) else 0
                        # monotone-decreasing interpolated precision
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side='left')
                        q = np.zeros(len(REC_THRS))
                        for r_i, p_i in enumerate(inds):
                            if p_i < len(pr):
                                q[r_i] = pr[p_i]
                        precision[t_i, :, k_i, a_i, m_i] = q
        return dict(precision=precision, recall=recall)

    @staticmethod
    def summarize(acc: Dict) -> Dict[str, float]:
        precision = acc['precision']
        recall = acc['recall']
        a_names = list(AREA_RNG.keys())

        def _ap(iou=None, area='all', max_det=100):
            a_i = a_names.index(area)
            m_i = MAX_DETS.index(max_det)
            p = precision[:, :, :, a_i, m_i]
            if iou is not None:
                p = p[[int(np.argmin(np.abs(IOU_THRS - iou)))]]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def _ar(area='all', max_det=100):
            a_i = a_names.index(area)
            m_i = MAX_DETS.index(max_det)
            r = recall[:, :, a_i, m_i]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        return {
            'mAP': _ap(), 'mAP_50': _ap(iou=0.5), 'mAP_75': _ap(iou=0.75),
            'mAP_s': _ap(area='small'), 'mAP_m': _ap(area='medium'),
            'mAP_l': _ap(area='large'),
            'AR@1': _ar(max_det=1), 'AR@10': _ar(max_det=10),
            'AR@100': _ar(max_det=100), 'AR_s@100': _ar(area='small'),
            'AR_m@100': _ar(area='medium'), 'AR_l@100': _ar(area='large'),
        }


def evaluate_coco(coco_gt: COCO, img_ids, cat_ids, results: List[dict],
                  metrics=('bbox', 'segm')) -> Dict[str, float]:
    """results: per-image dicts (dataset order) with keys:
    bboxes (n, 5) xyxy+score, labels (n,) contiguous label ids,
    masks: optional list of n RLE dicts / binary arrays."""
    assert len(results) == len(img_ids), (len(results), len(img_ids))
    out = {}
    for metric in metrics:
        dets: Dict[int, Dict[int, dict]] = {}
        for img_id, res in zip(img_ids, results):
            per_cat: Dict[int, dict] = {}
            boxes = np.asarray(res['bboxes'], np.float64).reshape(-1, 5)
            labels = np.asarray(res['labels'], np.int64).reshape(-1)
            for lbl in np.unique(labels):
                cat_id = cat_ids[int(lbl)]
                sel = labels == lbl
                xyxy = boxes[sel]
                xywh = np.stack([xyxy[:, 0], xyxy[:, 1],
                                 xyxy[:, 2] - xyxy[:, 0],
                                 xyxy[:, 3] - xyxy[:, 1]], axis=1)
                entry = dict(bboxes=xywh, scores=xyxy[:, 4])
                if metric == 'segm':
                    masks = res.get('masks')
                    if masks is None:
                        continue
                    entry['masks'] = [masks[i] for i in np.nonzero(sel)[0]]
                per_cat[cat_id] = entry
            dets[img_id] = per_cat
        ev = COCOEvaluator(coco_gt, img_ids, cat_ids, iou_type=metric)
        summary = COCOEvaluator.summarize(ev.evaluate(dets))
        for k, v in summary.items():
            out[f'{metric}_{k}'] = v
    return out
