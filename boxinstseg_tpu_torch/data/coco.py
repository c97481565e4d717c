"""Datasets (reference: mmdet/datasets/{custom,coco,pascal_voc,isaid}.py).

COCO-json based datasets with the reference's class lists and filtering
semantics, on top of the self-contained ``coco_api``. Evaluation delegates
to ``core.eval`` (pycocotools-free COCOeval reimplementation).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..registry import DATASETS, PIPELINES
from .coco_api import COCO
from .pipelines import Compose

COCO_CLASSES = (
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella',
    'handbag', 'tie', 'suitcase', 'frisbee', 'skis', 'snowboard',
    'sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard',
    'surfboard', 'tennis racket', 'bottle', 'wine glass', 'cup', 'fork',
    'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair',
    'couch', 'potted plant', 'bed', 'dining table', 'toilet', 'tv',
    'laptop', 'mouse', 'remote', 'keyboard', 'cell phone', 'microwave',
    'oven', 'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
    'scissors', 'teddy bear', 'hair drier', 'toothbrush')

VOC_CLASSES = (
    'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car', 'cat',
    'chair', 'cow', 'diningtable', 'dog', 'horse', 'motorbike', 'person',
    'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor')

ISAID_CLASSES = (
    'ship', 'storage_tank', 'baseball_diamond', 'tennis_court',
    'basketball_court', 'Ground_Track_Field', 'Bridge', 'Large_Vehicle',
    'Small_Vehicle', 'Helicopter', 'Swimming_pool', 'Roundabout',
    'Soccer_ball_field', 'plane', 'Harbor')

CITYSCAPES_CLASSES = ('person', 'rider', 'car', 'truck', 'bus', 'train',
                      'motorcycle', 'bicycle')


@DATASETS.register_module()
class CocoDataset:
    CLASSES = COCO_CLASSES

    def __init__(self, ann_file: str, pipeline: Sequence,
                 img_prefix: str = '', classes: Optional[Sequence] = None,
                 test_mode: bool = False, filter_empty_gt: bool = True,
                 min_size: Optional[int] = None, data_root=None,
                 seg_prefix=None, proposal_file=None):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        self.min_size = min_size
        if classes is not None:
            self.CLASSES = tuple(classes)
        self.coco = COCO(ann_file)
        self.cat_ids = self.coco.get_cat_ids(cat_names=self.CLASSES)
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.img_ids = self.coco.get_img_ids()
        self.data_infos = [self.coco.load_imgs([i])[0] for i in self.img_ids]
        if not test_mode:
            valid = self._filter_imgs()
            self.data_infos = [self.data_infos[i] for i in valid]
            self.img_ids = [self.img_ids[i] for i in valid]
        self.pipeline = Compose(pipeline)
        self.flag = self._aspect_ratio_flags()

    def __len__(self):
        return len(self.data_infos)

    def _filter_imgs(self, min_size: int = 32) -> List[int]:
        """Drop tiny images and (optionally) images without GT
        (reference: coco.py _filter_imgs)."""
        valid = []
        ids_with_ann = {a['image_id'] for a in self.coco.anns.values()
                        if not a.get('iscrowd', 0)
                        and a['category_id'] in self.cat2label}
        for i, info in enumerate(self.data_infos):
            if self.filter_empty_gt and info['id'] not in ids_with_ann:
                continue
            if min(info['width'], info['height']) < min_size:
                continue
            valid.append(i)
        return valid

    def _aspect_ratio_flags(self) -> np.ndarray:
        """Group flag: 1 if w/h > 1 (reference: custom.py
        _set_group_flag) — used by the aspect-ratio group sampler."""
        flags = np.zeros(len(self), np.uint8)
        for i, info in enumerate(self.data_infos):
            if info['width'] / info['height'] > 1:
                flags[i] = 1
        return flags

    def get_ann_info(self, idx: int) -> Dict:
        img_info = self.data_infos[idx]
        ann_ids = self.coco.get_ann_ids(img_ids=[img_info['id']])
        anns = self.coco.load_anns(ann_ids)
        bboxes, labels, masks = [], [], []
        for a in anns:
            if a.get('ignore', False) or a.get('iscrowd', 0):
                continue
            if a['category_id'] not in self.cat2label:
                continue
            x, y, w, h = a['bbox']
            if a.get('area', w * h) <= 0 or w < 1 or h < 1:
                continue
            bboxes.append([x, y, x + w, y + h])
            labels.append(self.cat2label[a['category_id']])
            masks.append(a.get('segmentation'))
        return dict(
            bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            segmentations=masks,
        )

    def prepare(self, idx: int, rng: Optional[np.random.RandomState] = None,
                scale=None) -> Optional[Dict]:
        info = self.data_infos[idx]
        results = dict(
            img_info=info,
            img_prefix=self.img_prefix,
            ann_info=self.get_ann_info(idx),
            bbox_fields=[], mask_fields=[],
            rng=rng,
        )
        if scale is not None:
            # per-batch multiscale pick: consumed (popped) by the FIRST
            # Resize only, so nested/mix-transform Resizes keep their
            # own scale policy
            results['batch_scale'] = tuple(scale)
        return self.pipeline(results)

    def __getitem__(self, idx):
        return self.prepare(idx)

    # ---- evaluation ---------------------------------------------------------
    def evaluate(self, results, metric=('bbox', 'segm'), **kwargs) -> Dict:
        """results: list (per image, in dataset order) of dicts with keys
        bboxes (n,5 xyxy+score), labels (n,), masks (list of RLE dicts,
        optional). Returns mAP dict like the reference's
        CocoDataset.evaluate (coco.py:592)."""
        from ..core.eval.coco_eval import evaluate_coco
        metrics = [metric] if isinstance(metric, str) else list(metric)
        if 'mAP' in metrics:
            # VOC-style AP@iou_thr (reference: XMLDataset.evaluate ->
            # mean_ap.eval_map); dets regrouped per class, GTs from the
            # coco annotations
            from ..core.eval.mean_ap import eval_map
            n_cls = len(self.cat_ids)
            dets, anns = [], []
            for i, r in enumerate(results):
                bb = np.asarray(r['bboxes'], np.float32).reshape(-1, 5)
                lb = np.asarray(r['labels'], np.int64).reshape(-1)
                dets.append([bb[lb == c] for c in range(n_cls)])
                gt = self.get_ann_info(i)
                anns.append(dict(bboxes=gt['bboxes'], labels=gt['labels']))
            mean_ap, _ = eval_map(dets, anns,
                                  iou_thr=kwargs.get('iou_thr', 0.5),
                                  dataset=kwargs.get('ds_name'))
            out = {'mAP': float(mean_ap)}
            rest = [m for m in metrics if m != 'mAP']
            if rest:
                out.update(evaluate_coco(self.coco, self.img_ids,
                                         self.cat_ids, results, rest))
            return out
        return evaluate_coco(self.coco, self.img_ids, self.cat_ids,
                             results, metrics)


@DATASETS.register_module()
class PascalVOCDataset(CocoDataset):
    """VOC2012+SBD in COCO-json format (reference: pascal_voc.py:22)."""
    CLASSES = VOC_CLASSES


@DATASETS.register_module()
class ISAIDDataset(CocoDataset):
    CLASSES = ISAID_CLASSES


@DATASETS.register_module()
class CityscapesDataset(CocoDataset):
    CLASSES = CITYSCAPES_CLASSES


@DATASETS.register_module()
class RepeatDataset:
    def __init__(self, dataset, times, **kwargs):
        from ..registry import DATASETS as _D
        self.dataset = _D.build(dataset) if isinstance(dataset, dict) \
            else dataset
        self.times = times
        self.CLASSES = self.dataset.CLASSES
        self.flag = np.tile(self.dataset.flag, times)

    def __len__(self):
        return self.times * len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def prepare(self, idx, rng=None, scale=None):
        return self.dataset.prepare(idx % len(self.dataset), rng,
                                    scale=scale)

    def evaluate(self, *a, **k):
        return self.dataset.evaluate(*a, **k)


@DATASETS.register_module()
class ConcatDataset:
    def __init__(self, datasets, **kwargs):
        from ..registry import DATASETS as _D
        self.datasets = [_D.build(d) if isinstance(d, dict) else d
                         for d in datasets]
        self.CLASSES = self.datasets[0].CLASSES
        self.cum = np.cumsum([len(d) for d in self.datasets])
        self.flag = np.concatenate([d.flag for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def _locate(self, idx):
        di = int(np.searchsorted(self.cum, idx, side='right'))
        base = 0 if di == 0 else int(self.cum[di - 1])
        return di, idx - base

    def __getitem__(self, idx):
        di, li = self._locate(idx)
        return self.datasets[di][li]

    def prepare(self, idx, rng=None, scale=None):
        di, li = self._locate(idx)
        return self.datasets[di].prepare(li, rng, scale=scale)


@DATASETS.register_module()
class ClassBalancedDataset:
    """Repeat-factor sampling (reference: dataset_wrappers.py
    ClassBalancedDataset): images containing rare categories are repeated
    with factor max(1, sqrt(t / f_c)) over their rarest category."""

    def __init__(self, dataset, oversample_thr: float, filter_empty_gt=True,
                 **kwargs):
        from ..registry import DATASETS as _D
        self.dataset = _D.build(dataset) if isinstance(dataset, dict) \
            else dataset
        self.oversample_thr = oversample_thr
        self.CLASSES = self.dataset.CLASSES

        # category frequencies over images
        n = len(self.dataset)
        cat_freq = {}
        img_cats = []
        for i in range(n):
            labels = set(self.dataset.get_ann_info(i)['labels'].tolist())
            img_cats.append(labels)
            for c in labels:
                cat_freq[c] = cat_freq.get(c, 0) + 1
        for c in cat_freq:
            cat_freq[c] /= n
        repeat = {c: max(1.0, np.sqrt(self.oversample_thr / f))
                  for c, f in cat_freq.items()}
        self.indices = []
        for i in range(n):
            r = max([repeat[c] for c in img_cats[i]], default=1.0)
            self.indices.extend([i] * int(np.ceil(r)))
        self.flag = self.dataset.flag[self.indices]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def prepare(self, idx, rng=None, scale=None):
        return self.dataset.prepare(self.indices[idx], rng, scale=scale)

    def evaluate(self, *a, **k):
        return self.dataset.evaluate(*a, **k)


@DATASETS.register_module()
class MultiImageMixDataset:
    """Wrapper for mix transforms (reference: dataset_wrappers.py
    MultiImageMixDataset). The shipped box-supervised configs do not use
    mosaic/mixup; this wrapper applies its pipeline per sample and exposes
    get_indexes-style mixing hooks for custom transforms."""

    def __init__(self, dataset, pipeline, **kwargs):
        from ..registry import DATASETS as _D, PIPELINES
        from .pipelines import Compose
        self.dataset = _D.build(dataset) if isinstance(dataset, dict) \
            else dataset
        self._pipeline_cfg = [dict(t) if isinstance(t, dict) else t
                              for t in pipeline]
        self.pipeline = Compose(pipeline)
        self._skip_type_keys = ()
        self.CLASSES = self.dataset.CLASSES
        self.flag = self.dataset.flag

    def update_skip_type_keys(self, skip_type_keys):
        """Drop the named transform types from the pipeline (reference:
        dataset_wrappers.py MultiImageMixDataset.update_skip_type_keys,
        driven by YOLOXModeSwitchHook)."""
        from .pipelines import Compose
        self._skip_type_keys = tuple(skip_type_keys)
        kept = [t for t in self._pipeline_cfg
                if not (isinstance(t, dict)
                        and t.get('type') in self._skip_type_keys)
                and type(t).__name__ not in self._skip_type_keys]
        self.pipeline = Compose(kept)

    def __len__(self):
        return len(self.dataset)

    def prepare(self, idx, rng=None, scale=None):
        results = self.dataset.prepare(idx, rng, scale=scale)
        if results is None:
            return None
        results['dataset'] = self.dataset
        out = self.pipeline(results)
        if out is not None:
            out.pop('dataset', None)
        return out

    def __getitem__(self, idx):
        return self.prepare(idx)

    def evaluate(self, *a, **k):
        return self.dataset.evaluate(*a, **k)
