"""Evaluation loop, counterpart of ``boxinstseg_tpu/apis/test.py``
(reference: mmdet/apis/test.py single_gpu_test + CocoDataset.evaluate).

The device side is one ``predict`` a batch over fixed-capacity detections.
``format_detection`` then crops and rescales each image's stride-4 mask
scores to its original resolution and binarises them; it runs in torch on
the device the masks are on (the card in ``run_evaluation``, the CPU for
numpy inputs), and the binary masks come to the host for the RLE codec
(the reference's GPU->CPU mask handoff, condinst_head.py:1281-1283, and
encode_mask_results, apis/test.py:64-66).

The bilinear resizes are ``ops.upsample.interpolate_bilinear``: cv2
``INTER_LINEAR``'s arithmetic (source coordinate ``(dst + 0.5) * in / out
- 0.5``, clamped to the edges), so no cv2 is needed.

Under a process group (``parallel.dist``) rank r evaluates images r, r + W,
... (padded with duplicates to one length on every rank); the ranks' parts
are gathered on rank 0 through a directory all of them see
(``collect_results_cpu``), and rank 0 alone computes the metrics.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.structures import InstanceData
from ..data.batcher import StaticBatcher
from ..data.coco_api import rle_encode
from ..data.loader import EvalLoader
from ..engine.train_state import autocast_bf16
from ..models.detectors.maskformer import panoptic_postprocess
from ..native import rle_lib
from ..ops.upsample import aligned_bilinear, interpolate_bilinear
from ..parallel import dist as pdist
from ..utils.env import set_tf32, tf32_from_cfg
from .train import apply_precision_policy, batch_to_device, get_logger


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def upsample_masks(masks, img_shape, ori_shape, out_stride: int = 4,
                   aligned: bool = True) -> torch.Tensor:
    """(D, H/s, W/s) maps on the padded canvas -> (D, ori_h, ori_w): up by
    ``out_stride`` (AdelaiDet-aligned for CondInst, plain bilinear for the
    SOLO and MaskFormer families), cropped to ``img_shape``, resized to
    ``ori_shape``. The fp32 result stays on the input's device."""
    m = torch.as_tensor(masks).float()
    ih, iw = int(img_shape[0]), int(img_shape[1])
    if aligned:
        full = aligned_bilinear(m, out_stride)
    else:
        full = interpolate_bilinear(m, (m.shape[-2] * out_stride,
                                        m.shape[-1] * out_stride))
    return interpolate_bilinear(full[..., :ih, :iw],
                                (int(ori_shape[0]), int(ori_shape[1])))


def postprocess_masks(mask_scores, img_shape, ori_shape,
                      out_stride: int = 4, thresh: float = 0.5,
                      aligned: bool = True) -> List[np.ndarray]:
    """(D, H/s, W/s) sigmoid scores on the padded canvas -> list of
    (ori_h, ori_w) uint8 masks (reference: CondInstMaskHead.simple_test
    resize-crop-threshold chain)."""
    full = upsample_masks(mask_scores, img_shape, ori_shape, out_stride,
                          aligned)
    return list((full > thresh).to(torch.uint8).cpu().numpy())


def _mask_extents(binary: torch.Tensor) -> np.ndarray:
    """(D, H, W) bool -> (D, 4) float64 xyxy extents (x2, y2 exclusive), 0
    for an empty mask (reference format_results,
    single_stage_boxseg.py:75-90)."""
    def span(hit):                           # (D, n) bool -> first, last+1
        hit = hit.int()
        return hit.argmax(dim=1), hit.shape[1] - hit.flip(1).argmax(dim=1)

    x1, x2 = span(binary.any(dim=1))
    y1, y2 = span(binary.any(dim=2))
    boxes = torch.stack([x1, y1, x2, y2], dim=1).double()
    return torch.where(binary.flatten(1).any(1)[:, None], boxes,
                       torch.zeros_like(boxes)).cpu().numpy()


def format_detection(out: Dict, i: int, img_shape, ori_shape,
                     test_cfg: Optional[Dict] = None) -> InstanceData:
    """Format one image's ``predict`` output into host results.

    ``out`` holds numpy arrays or tensors; the mask fields are resized
    where they lie. Handles the FCOS family (CondInst: has 'bboxes'), the
    SOLO family (masks only: boxes from the mask extents) and the
    MaskFormer family ('masks_logit': binarised at logit 0 and rescored at
    the original resolution), and with ``test_cfg.panoptic_on`` the
    panoptic fusion. Returns an ``InstanceData`` with bboxes (n, 5) incl.
    the score, labels (n,) and masks, a list of (oh, ow) uint8."""
    test_cfg = test_cfg or {}
    valid = _host(out['valid'][i])
    labels = _host(out['labels'][i])[valid]
    scores = _host(out['scores'][i])[valid]
    ih, iw = int(img_shape[0]), int(img_shape[1])
    oh, ow = int(ori_shape[0]), int(ori_shape[1])
    meta = dict(img_shape=(ih, iw), ori_shape=(oh, ow))
    if 'pan_cls' in out and test_cfg.get('panoptic_on', False):
        # the panoptic fusion at the original resolution (reference
        # maskformer_fusion_head.py simple_test :211-226 interpolates the
        # per-query logits to ori_shape, then panoptic_postprocess)
        logits = upsample_masks(out['pan_masks_logit'][i], img_shape,
                                ori_shape, aligned=False)
        fusion = dict(test_cfg.get('panoptic_fusion', {}))
        meta['pan_results'] = panoptic_postprocess(
            torch.as_tensor(out['pan_cls'][i]).float().to(logits.device),
            logits,
            num_things_classes=int(fusion.get('num_things_classes', 80)),
            num_stuff_classes=int(fusion.get('num_stuff_classes', 53)),
            object_mask_thr=float(test_cfg.get('object_mask_thr', 0.8)),
            iou_thr=float(test_cfg.get('iou_thr', 0.8)),
            filter_low_score=bool(test_cfg.get('filter_low_score', False))
        ).cpu().numpy()
    keep = torch.from_numpy(np.flatnonzero(valid))
    if 'masks_logit' in out:
        # the MaskFormer / Box2Mask fusion-head chain (maskformer_fusion_
        # head.py simple_test :200-232, instance_postprocess :112-162):
        # logits to the original resolution, binarised at 0, rescored by
        # the mean sigmoid inside the mask
        m = torch.as_tensor(out['masks_logit'][i])
        full = upsample_masks(m[keep.to(m.device)], img_shape, ori_shape,
                              aligned=False)
        binary = full > 0
        pos = binary.sum(dim=(1, 2)).double()
        rescore = (torch.sigmoid(full) * binary).sum(dim=(1, 2)).double() \
            / (pos + 1e-6)
        scores = scores * rescore.cpu().numpy().astype(scores.dtype)
        # the reference gives an empty mask score 0; it is dropped here
        # (its RLE is empty and it cannot match anything in COCOeval)
        nonempty = (pos > 0).cpu().numpy()
        labels, scores = labels[nonempty], scores[nonempty]
        binary = binary[torch.from_numpy(nonempty).to(binary.device)]
        is_solo = True
    else:
        is_solo = 'bboxes' not in out
        thresh = float(test_cfg.get('mask_thr', 0.5)) if is_solo else 0.5
        m = torch.as_tensor(out['masks'][i])
        binary = upsample_masks(m[keep.to(m.device)], img_shape, ori_shape,
                                aligned=not is_solo) > thresh
    if is_solo:
        boxes = np.concatenate([_mask_extents(binary), scores[:, None]], -1)
    else:
        boxes = np.concatenate([_host(out['bboxes'][i])[valid],
                                scores[:, None]], -1)
    masks = list(binary.to(torch.uint8).cpu().numpy())
    return InstanceData(metainfo=meta, bboxes=boxes.astype(np.float64),
                        labels=labels.astype(np.int64), masks=masks)


def eval_batcher(cfg) -> StaticBatcher:
    """The test-time batcher of ``cfg``: its canvases, no annotations."""
    return StaticBatcher(canvases=cfg.get('canvases', [(800, 1344),
                                                       (1344, 800)]),
                         max_gts=1)


def predict_batch(model: torch.nn.Module, batch: Dict[str, np.ndarray],
                  bf16: bool) -> Dict[str, torch.Tensor]:
    """``predict`` on one host batch of ``eval_batcher``: its image,
    img_shape and scale_factor on the model's device, under
    ``torch.inference_mode()`` and, with ``bf16``, bf16 autocast."""
    device = next(model.parameters()).device
    inputs = batch_to_device({k: batch[k] for k in (
        'image', 'img_shape', 'scale_factor')}, device)
    with torch.inference_mode(), autocast_bf16(device, bf16):
        return model.predict(inputs)


def shard_indices(n: int, rank: int, world: int) -> List[int]:
    """Rank ``rank``'s images of ``n``: rank, rank + world, ..., padded with
    its last index to ceil(n / world), so every rank runs as many batches
    (the JAX package's shard; the duplicates overwrite their own result at
    the gather)."""
    mine = list(range(rank, n, world))
    per = -(-n // world)
    while len(mine) < per:
        mine.append(mine[-1] if mine else rank % max(n, 1))
    return mine


def _shared_tmpdir(cfg) -> str:
    """``cfg.eval_tmpdir``, or a new temporary directory of rank 0 whose
    path is broadcast to the other ranks (mmdet's collect_results_cpu; the
    ranks must share a file system)."""
    if cfg.get('eval_tmpdir'):
        os.makedirs(cfg.eval_tmpdir, exist_ok=True)
        return cfg.eval_tmpdir
    path = torch.zeros(512, dtype=torch.uint8)
    if pdist.rank() == 0:
        raw = tempfile.mkdtemp(prefix='eval_gather_').encode()
        path[:len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    path = pdist.all_reduce_sum(path.to(pdist.collective_device()))
    return bytes(path.cpu().tolist()).rstrip(b'\0').decode()


def collect_results_cpu(part: List, part_indices: List[int], size: int,
                        tmpdir: str) -> Optional[List]:
    """The ranks' results merged by dataset index on rank 0 (None on the
    other ranks), the counterpart of the JAX package's
    ``collect_results_cpu``: each rank pickles (indices, results) into
    ``tmpdir``, a barrier, rank 0 reads every part, a barrier, and rank 0
    removes ``tmpdir``."""
    with open(os.path.join(tmpdir, f'part_{pdist.rank()}.pkl'), 'wb') as f:
        pickle.dump((part_indices, part), f)
    pdist.barrier()
    merged = None
    if pdist.rank() == 0:
        merged = [None] * size
        for r in range(pdist.world_size()):
            with open(os.path.join(tmpdir, f'part_{r}.pkl'), 'rb') as f:
                inds, res = pickle.load(f)
            for i, rec in zip(inds, res):
                merged[i] = rec
        missing = [i for i, rec in enumerate(merged) if rec is None]
        if missing:
            raise RuntimeError(f'eval gather: no result for images '
                               f'{missing[:8]}')
    pdist.barrier()
    if pdist.rank() == 0:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return merged


def run_evaluation(model: torch.nn.Module, dataset, cfg,
                   metrics=('bbox', 'segm'),
                   max_images: Optional[int] = None,
                   save_results: Optional[str] = None) -> Dict[str, float]:
    """Evaluate ``model`` (on its own device) over ``dataset`` in batches of
    ``cfg.data.samples_per_gpu``; returns the metric dict (on rank 0 under a
    process group, ``{}`` on the other ranks). Predicts under
    ``torch.inference_mode()`` and, when the config asks for mixed
    precision, bf16 autocast. On a GPU the native RLE codec must build:
    its failure raises."""
    device = next(model.parameters()).device
    if device.type == 'cuda' and rle_lib() is None:
        from .. import native
        raise RuntimeError(f'the native RLE codec did not build: '
                           f'{native.BUILD_ERROR}')
    logger = get_logger()
    set_tf32(tf32_from_cfg(cfg))
    bf16 = apply_precision_policy(cfg)
    b = cfg.get('data', {}).get('samples_per_gpu', 2)
    n_total = len(dataset) if max_images is None \
        else min(max_images, len(dataset))
    rank, world = pdist.rank(), pdist.world_size()
    indices = shard_indices(n_total, rank, world)
    loader = EvalLoader(dataset, b, eval_batcher(cfg), indices=indices)
    test_cfg = dict(cfg.model.get('test_cfg', {}) or {})
    if cfg.model.get('panoptic_fusion_head'):
        # the class split for the panoptic fusion (the reference builds
        # the fusion head from this config node)
        test_cfg['panoptic_fusion'] = dict(cfg.model['panoptic_fusion_head'])

    model.eval()
    results = []
    for batch, real, metas in loader:
        out = predict_batch(model, batch, bf16)
        for i in range(real):
            det = format_detection(out, i, metas[i]['img_shape'][:2],
                                   metas[i]['ori_shape'][:2], test_cfg)
            rec = dict(bboxes=det['bboxes'], labels=det['labels'],
                       masks=[rle_encode(m) for m in det['masks']])
            if 'pan_results' in det.metainfo:
                rec['pan_results'] = det.metainfo['pan_results']
            results.append(rec)
        if len(results) % (20 * b) < b:
            logger.info(f'eval: {len(results)}/{len(indices)}'
                        + (f' (rank {rank})' if world > 1 else ''))

    if pdist.is_distributed():
        results = collect_results_cpu(results, indices, n_total,
                                      _shared_tmpdir(cfg))
        if rank != 0:
            return {}
    if save_results:
        with open(save_results, 'w') as f:
            json.dump([dict(bboxes=r['bboxes'].tolist(),
                            labels=r['labels'].tolist(),
                            masks=r['masks']) for r in results], f)
    if max_images is not None:
        from ..core.eval.coco_eval import evaluate_coco
        return evaluate_coco(dataset.coco, dataset.img_ids[:len(results)],
                             dataset.cat_ids, results, list(metrics))
    return dataset.evaluate(results, metric=list(metrics))
