"""A predict cell: the program's ``predict_batch`` and ``format_detection``
in a closed loop at batch 1, one client, as ``run_evaluation`` runs them
before the RLE codec.

Set-up builds the detector on the device in ``eval()``, loads the seeded
weights and draws the pool of test images, each batched by the port's
``eval_batcher``; every pool image is predicted and formatted once. The
window then cycles the pool, one image after the other; the traced run
also times each image from its submission to its formatted result on the
host. After the window a sample of the pool's images, drawn from the
seed, is compared with the reference: each one's last result in the
window."""
from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from . import traffic, trace
from .weights import load_weights, seeded_weights


def _port_cfg(cfg: dict):
    from boxinstseg_tpu_torch.config import Config
    d = {k: v for k, v in cfg.items() if k not in ('init', 'schedule')}
    d['data'] = dict(samples_per_gpu=1,
                     test=dict(pipeline=cfg['test_pipeline']))
    return Config.fromdict(d)


# detections that the faults 'altered_few' and 'duplicated' touch
FAULT_FEW = 3
FAULTS_PLANTED = ('altered', 'altered_few', 'duplicated')


def plant(det, fault: str) -> None:
    """Alter one image's answer where ``format_detection`` produces it, for
    the harness's own tests: 'altered' inverts every mask, 'altered_few'
    the masks of the ``FAULT_FEW`` best detections, 'duplicated' puts a
    copy of the best detection in place of the ``FAULT_FEW`` next ones."""
    masks = det['masks']
    order = np.argsort(-np.asarray(det['bboxes'])[:, 4], kind='stable')
    if fault == 'altered':
        masks[:] = [1 - m for m in masks]
    elif fault == 'altered_few':
        for i in order[:FAULT_FEW]:
            masks[i] = 1 - masks[i]
    elif fault == 'duplicated':
        best = order[0]
        for i in order[1:1 + FAULT_FEW]:
            masks[i] = masks[best].copy()
            det['bboxes'][i] = det['bboxes'][best]
            det['labels'][i] = det['labels'][best]
    else:
        raise ValueError(f'no fault {fault!r}')


def invert_attention(model) -> None:
    """A fault in the decoder for the harness's own tests: every layer's
    cross-attention takes the opposite of the mask it was given."""
    def hook(mod, args, kwargs):
        kwargs['cross_attn_mask'] = ~kwargs['cross_attn_mask']
        return args, kwargs

    for layer in model.panoptic_head.transformer_decoder.layers:
        layer.register_forward_pre_hook(hook, with_kwargs=True)


def run(ctx: Dict, device='cuda', fault=None) -> Dict:
    """One run of a predict cell. ``fault``, for the harness's own tests:
    'attention_inverted' (``invert_attention``), or one that alters the
    first sampled image's answer where ``format_detection`` produces it
    (``plant``)."""
    from boxinstseg_tpu_torch.apis.test import (eval_batcher,
                                                format_detection,
                                                predict_batch)
    from boxinstseg_tpu_torch.apis.train import apply_precision_policy
    from boxinstseg_tpu_torch.registry import build_detector
    from boxinstseg_tpu_torch.utils.env import set_tf32
    import boxinstseg_tpu_torch.models  # noqa: F401  (registers)
    args, cfg, mix = ctx['args'], ctx['cfg'], ctx['mix']
    dev = torch.device(device)
    is_cuda = dev.type == 'cuda'
    spans = trace.Spans(bool(args.trace))
    pcfg = _port_cfg(cfg)
    set_tf32(bool(cfg.get('tf32', False)))
    bf16 = apply_precision_policy(pcfg)
    with torch.device(dev):
        model = build_detector(pcfg.model.copy())
    named_shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    load_weights(model, seeded_weights(named_shapes, args.seed, dev,
                                       cfg['init']))
    model.eval()
    spans.hook_children(model)
    if fault == 'attention_inverted':
        invert_attention(model)
    test_cfg = dict(pcfg.model.get('test_cfg', {}) or {})
    if pcfg.model.get('panoptic_fusion_head'):
        test_cfg['panoptic_fusion'] = dict(pcfg.model['panoptic_fusion_head'])
    batcher = eval_batcher(pcfg)
    samples = traffic.predict_images(mix, args.seed, cfg['img_norm_cfg'])
    batches = [batcher([s]) for s in samples]
    rng = np.random.default_rng(int(args.seed) + 1)
    sample = sorted(rng.choice(len(batches), mix['checked_images'],
                               replace=False).tolist())
    kept = {}

    def one(j, clock=None):
        b = batches[j % len(batches)]
        smp = samples[j % len(samples)]
        t = time.perf_counter()
        with spans('predict'):
            out = predict_batch(model, b, bf16)
        t1 = time.perf_counter()
        with spans('format'):
            det = format_detection(out, 0, smp['img_shape'][:2],
                                   smp['ori_shape'][:2], test_cfg)
        if clock is not None:
            t2 = time.perf_counter()
            clock['predict'].append(t1 - t)
            clock['format'].append(t2 - t1)
            clock['latency'].append(t2 - t)
        if fault in FAULTS_PLANTED and j % len(batches) == sample[0]:
            plant(det, fault)
        if j % len(batches) in sample:
            kept[j % len(batches)] = det
        return det

    for j in range(len(batches)):
        one(j)
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = dict(setup_s=time.perf_counter() - ctx['t0'])
    kept.clear()
    idx = 0
    if args.trace:
        n = int(mix['trace_images'])
        # the timing pass (trace.py): the window, the device's busy time,
        # each image's host times and the canvases that the FLOPs count
        spans.enabled = False
        clock = dict(predict=[], format=[], latency=[])
        light = trace.device_profiler(is_cuda)
        with light:
            w0 = time.perf_counter()
            for _ in range(n):
                one(idx, clock)
                idx += 1
            if is_cuda:
                torch.cuda.synchronize()
            window = time.perf_counter() - w0
        timed = [tuple(batches[k % len(batches)]['image'].shape)
                 for k in range(n)]
        # the attribution pass: spans, host ops and the ops' shapes
        spans.enabled = True
        prof = trace.profiler()
        with prof:
            with spans('window'):
                for _ in range(n):
                    one(idx)
                    idx += 1
                if is_cuda:
                    torch.cuda.synchronize()
        records = trace.read_trace(prof)
        records.update(window_s=window, busy_s=trace.device_busy(light),
                       host_s=dict(predict=clock['predict'],
                                   format=clock['format']),
                       latency_s=clock['latency'])
        out.update(records=records, steps=n, images=n,
                   timed_canvases=timed)
    else:
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < args.seconds:
            one(idx)
            idx += 1
        out.update(window_s=time.perf_counter() - w0, images=idx)
    out.update(attempted=idx, failed=0,
               memory_peak_bytes=(torch.cuda.max_memory_allocated()
                                  if is_cuda else 0),
               named_shapes=named_shapes, kept=kept, samples=samples)
    out['steer'], out['rerun_equal'] = decoder_masks(
        model, {j: batches[j] for j in kept}, bf16,
        lambda j, o: format_detection(
            o, 0, samples[j]['img_shape'][:2], samples[j]['ori_shape'][:2],
            test_cfg), kept)
    spans.remove()
    del model
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    return out


def decoder_masks(model, batches: Dict, bf16: bool, fmt, kept: Dict):
    """The attention masks that the program's decoder layers took, a layer,
    for each sampled image, from a second ``predict_batch`` of the image
    after the window (the window's own call is left untouched): the
    reference takes them in place of its own thresholding (``steer`` of
    the frozen ``Box2MaskHead``). Also whether each second result equals
    the window's last one, bit for bit. Empty for a model without a
    masked-attention decoder."""
    from boxinstseg_tpu_torch.apis.test import predict_batch
    head = getattr(model, 'panoptic_head', None)
    if head is None or not hasattr(head, 'transformer_decoder'):
        return {}, {}
    masks, equal = {}, {}
    for j, b in batches.items():
        took = []

        def hook(mod, args, kwargs):
            took.append(kwargs['cross_attn_mask'][:, 0].clone())

        handles = [layer.register_forward_pre_hook(hook, with_kwargs=True)
                   for layer in head.transformer_decoder.layers]
        try:
            det = fmt(j, predict_batch(model, b, bf16))
        finally:
            for h in handles:
                h.remove()
        masks[j] = [t.cpu() for t in took]
        w = kept[j]
        equal[j] = bool(
            np.array_equal(np.asarray(det['bboxes']), np.asarray(w['bboxes']))
            and np.array_equal(np.asarray(det['labels']),
                               np.asarray(w['labels']))
            and len(det['masks']) == len(w['masks'])
            and all(np.array_equal(a, c) for a, c in zip(det['masks'],
                                                         w['masks'])))
    return masks, equal


def reference_predict(model, batch, smp, dev, steer=None, tf32_on=False):
    """The reference's formatted result of one image, its decoder steered
    by ``steer`` (or by its own thresholding), with the largest margin of
    the thresholding it skipped (``flip_margin``) and the masks it took."""
    from reference import predict as RP
    from reference.train import tf32
    head = model.panoptic_head
    head.steer, head.steer_log, head.capture = steer, [], []
    tf32(tf32_on)
    try:
        out = RP.predict_one(model, batch, dev)
    finally:
        tf32(False)
    ref = RP.format_maskformer(out, 0, smp['img_shape'][:2],
                               smp['ori_shape'][:2])
    ref['flip_margin'] = max([0.0] + [g['margin'] for g in head.steer_log])
    ref['flip_pixels'] = sum(g['pixels'] for g in head.steer_log)
    ref['took'] = head.capture
    head.steer = head.steer_log = head.capture = None
    return ref


def check(ctx: Dict, run_out: Dict, device='cuda', tf32_on=False) -> Dict:
    """Each sampled image's last result against the reference's
    (``reference.compare.predict_gaps``), the reference's decoder taking
    the program's attention masks (``decoder_masks``); ``flip_margin`` the
    largest |logit| where its own thresholding would have blocked
    otherwise. An image the window never reached is left out, and none
    reached fails."""
    from reference import model as RM
    from reference.compare import predict_gaps
    cfg, args = ctx['cfg'], ctx['args']
    names = RM.named_shapes(cfg)
    if names != run_out['named_shapes']:
        raise RuntimeError('the program\'s parameters differ from the '
                           'reference\'s in name or shape')
    dev = torch.device(device)
    model = RM.build(cfg, dev)
    load_weights(model, seeded_weights(names, args.seed, dev, cfg['init']))
    model.eval()
    batcher = RM.test_batcher(cfg)
    per_image = []
    for j, det in sorted(run_out['kept'].items()):
        smp = run_out['samples'][j]
        ref = reference_predict(model, batcher([smp]), smp, dev,
                                run_out['steer'].get(j), tf32_on)
        gaps = predict_gaps(det, ref, dev)
        gaps.update(flip_margin=ref['flip_margin'],
                    flip_pixels=ref['flip_pixels'])
        per_image.append(gaps)
    del model
    if not per_image:
        return dict(gaps=dict(mask_box_gap=float('inf'),
                              score_gap=float('inf'),
                              flip_margin=float('inf')))
    gaps = {k: max(g[k] for g in per_image) for k in per_image[0]}
    return dict(gaps=gaps, detail=dict(
        images=len(per_image),
        rerun_equal=sorted(run_out['rerun_equal'].values())))


def control(ctx: Dict, run_out: Dict, device='cuda') -> Dict:
    """The control's gaps: the reference with TF32 on in the program's
    place, its results and the attention masks its decoder took compared
    with the reference as the program's are, over the same sampled images
    (the worst image)."""
    from reference import model as RM
    from reference.compare import predict_gaps
    cfg, args = ctx['cfg'], ctx['args']
    dev = torch.device(device)
    model = RM.build(cfg, dev)
    load_weights(model, seeded_weights(RM.named_shapes(cfg), args.seed, dev,
                                       cfg['init']))
    model.eval()
    batcher = RM.test_batcher(cfg)
    per = []
    for j in sorted(run_out['kept']):
        smp = run_out['samples'][j]
        b = batcher([smp])
        lo = reference_predict(model, b, smp, dev, tf32_on=True)
        ref = reference_predict(model, b, smp, dev, steer=lo['took'])
        as_det = dict(bboxes=np.concatenate([lo['boxes'],
                                             lo['scores'][:, None]], 1),
                      labels=lo['labels'],
                      masks=list(lo['masks'].to(torch.uint8).cpu().numpy()))
        gaps = predict_gaps(as_det, ref, dev)
        gaps.update(flip_margin=ref['flip_margin'],
                    flip_pixels=ref['flip_pixels'])
        per.append(gaps)
    del model
    return {g: max(p[g] for p in per) for g in per[0]}


def yardstick(ctx: Dict, run_out: Dict, device='cuda') -> Dict:
    """``flops``: the convolution and matrix-product FLOPs of the forward
    of every image of the timing pass, ``FlopCounterMode`` over the frozen
    reference's predict, once per canvas. No kernel of this entry needs
    its inputs' values."""
    from torch.utils.flop_counter import FlopCounterMode
    from reference import model as RM
    cfg, args = ctx['cfg'], ctx['args']
    dev = torch.device(device)
    names = RM.named_shapes(cfg)
    model = RM.build(cfg, dev)
    load_weights(model, seeded_weights(names, args.seed, dev, cfg['init']))
    model.eval().requires_grad_(False)
    batcher = RM.test_batcher(cfg)
    flops = {}
    for smp in run_out['samples']:
        b = batcher([smp])
        key = tuple(b['image'].shape)
        if key in run_out['timed_canvases'] and key not in flops:
            counter = FlopCounterMode(display=False)
            with counter:
                model.predict({k: torch.from_numpy(np.ascontiguousarray(v))
                               .to(dev) if k != 'image' else
                               torch.from_numpy(v).to(dev)
                               .permute(0, 3, 1, 2).contiguous()
                               for k, v in b.items()})
            flops[key] = counter.get_total_flops()
    del model
    return dict(flops=float(sum(flops[k] for k in run_out['timed_canvases'])))


def end_to_end(run_out: Dict) -> Dict[str, float]:
    return dict(predict_images_per_s=run_out['images'] / run_out['window_s'],
                setup_s=run_out['setup_s'])
