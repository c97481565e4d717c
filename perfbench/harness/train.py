"""A train cell: the program's step, as ``train_detector`` builds it,
driven over a pool of seeded batches.

Set-up builds the detector on the device, loads the seeded weights, builds
the optimizer, the LR schedule and ``make_train_step`` as
``train_detector`` does, and draws the pool. The first ``checked_steps``
steps go through the window's own call and copy on the pool's first
batches; their losses, the first gradient as the optimizer holds it and
each leaf's change are kept for the check. Further steps warm up every
(canvas, GT capacity) shape of the pool that the checked steps did not
meet. The window then cycles the pool: each batch copied by
``batch_to_device``, the step called, a CUDA event recorded after it on
the step's stream, the logs read every ``log_config.interval`` steps as
``TextLoggerHook`` does; it closes with a device sync.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import torch

from . import traffic, trace
from .weights import load_weights, seeded_weights


def shape_key(batch) -> tuple:
    return tuple(batch['image'].shape) + (batch['gt_valid'].shape[1],)


class Program:
    """The port's train step over the cell's configuration."""

    def __init__(self, cfg: dict, device, seed: int, spans: trace.Spans):
        from boxinstseg_tpu_torch.apis.train import (
            apply_precision_policy, train_schedule)
        from boxinstseg_tpu_torch.config import Config
        from boxinstseg_tpu_torch.engine.optimizers import build_optimizer
        from boxinstseg_tpu_torch.engine.train_state import make_train_step
        from boxinstseg_tpu_torch.registry import build_detector
        from boxinstseg_tpu_torch.utils.env import set_tf32
        import boxinstseg_tpu_torch.models  # noqa: F401  (registers)
        self.device = torch.device(device)
        pcfg = Config.fromdict({k: v for k, v in cfg.items()
                                if k not in ('init', 'schedule')})
        set_tf32(bool(cfg.get('tf32', False)))
        with torch.device(self.device):
            self.model = build_detector(pcfg.model.copy())
        self.named_shapes = [(n, tuple(p.shape))
                             for n, p in self.model.named_parameters()]
        load_weights(self.model, seeded_weights(
            self.named_shapes, seed, self.device, cfg['init']))
        self.optimizer = build_optimizer(pcfg.optimizer,
                                         self.model.named_parameters())
        sched = cfg['schedule']
        lr_fn = train_schedule(pcfg, sched['global_batch'],
                               sched['dataset_images'])[0]
        clip = (pcfg.get('optimizer_config') or {}).get('grad_clip')
        self.step_fn = make_train_step(self.model, self.optimizer, lr_fn,
                                       clip,
                                       bf16=apply_precision_policy(pcfg))
        spans.wrap_method(self.model, 'loss', 'loss')
        spans.hook_children(self.model)

    def params(self) -> List[torch.Tensor]:
        return [p for _, p in self.model.named_parameters()]

    def first_grad_norms(self) -> torch.Tensor:
        """Each leaf's gradient as the optimizer took it in its first step,
        worked out from its state: SGD's momentum buffer less the decay it
        added, AdamW's first moment over (1 - beta1)."""
        group_of = {id(p): g for g in self.optimizer.param_groups
                    for p in g['params']}
        out = []
        for p in self.params():
            st = self.optimizer.state.get(p, {})
            g = group_of[id(p)]
            if 'momentum_buffer' in st and st['momentum_buffer'] is not None:
                grad = st['momentum_buffer'] - g['weight_decay'] * self.p0[
                    len(out)]
            elif 'exp_avg' in st:
                grad = st['exp_avg'] / (1.0 - g['betas'][0])
            else:
                grad = torch.full_like(p, float('nan'))
            out.append(grad.float().norm())
        return torch.stack(out).cpu()


def pool_batches(cfg: dict, mix: dict, seed: int, batcher):
    """(numpy batches of the pool, the samples of the checked ones)."""
    norm = cfg['img_norm_cfg']
    num_classes = _num_classes(cfg['model'])
    pool = traffic.train_samples(mix, seed, norm, num_classes,
                                 bool(cfg.get('with_gt_masks', False)))
    batches = [batcher(samples) for samples in pool]
    kept = pool[:mix['checked_steps']]
    return batches, kept


def _num_classes(model_cfg: dict) -> int:
    for sub in model_cfg.values():
        if isinstance(sub, dict):
            for key in ('num_classes', 'num_things_classes'):
                if key in sub:
                    return int(sub[key])
    raise ValueError('no num_classes in the model config')


def port_batcher(cfg: dict):
    """The port's ``StaticBatcher`` as ``build_train_loader`` makes it."""
    from boxinstseg_tpu_torch.data.batcher import StaticBatcher
    mh = cfg['model'].get('mask_head') or {}
    supervised = cfg['model'].get('type') == 'CondInst' and \
        not mh.get('boxinst_enabled', True)
    return StaticBatcher(
        canvases=cfg['canvases'], max_gts=cfg.get('max_gts', 100),
        bottom_pixels_removed=mh.get('bottom_pixels_removed', 10),
        with_masks=bool(cfg.get('with_gt_masks',
                                not mh.get('boxinst_enabled', True))),
        mask_stride=1 if supervised else 4,
        gt_buckets=cfg.get('gt_buckets'))


def run(ctx: Dict, device='cuda', fault=None) -> Dict:
    """One run of a train cell; returns what ``run.py`` reports. ``fault``
    plants a fault in the timed path for the harness's own tests:
    'unchanged' (the step leaves the state as it was) or 'half_batch'
    (the step sees only the first half of each batch)."""
    from boxinstseg_tpu_torch.apis.train import batch_to_device
    args, cfg, mix = ctx['args'], ctx['cfg'], ctx['mix']
    t0 = ctx['t0']
    dev = torch.device(device)
    is_cuda = dev.type == 'cuda'
    spans = trace.Spans(bool(args.trace))
    prog = Program(cfg, dev, args.seed, spans)
    step_fn = prog.step_fn
    if fault == 'unchanged':
        saved = [p.detach().clone() for p in prog.params()]

        def step_fn(batch, step, inner=prog.step_fn):
            logs = inner(batch, step)
            with torch.no_grad():
                torch._foreach_copy_(prog.params(), saved)
            return logs
    elif fault == 'half_batch':
        def step_fn(batch, step, inner=prog.step_fn):
            half = batch['image'].shape[0] // 2
            return inner({k: v[:half] for k, v in batch.items()}, step)
    batches, kept = pool_batches(cfg, mix, args.seed, port_batcher(cfg))
    start = int(cfg['schedule']['start_step'])
    checked = int(mix['checked_steps'])
    interval = int((cfg.get('log_config') or {}).get('interval', 1))

    def one_step(i, step):
        with spans('batch_to_device'):
            batch = batch_to_device(batches[i % len(batches)], dev)
        with spans('step'):
            return step_fn(batch, step)

    # the checked steps, then a step of every shape not met yet
    prog.p0 = [p.detach().clone() for p in prog.params()]
    losses = []
    grad1 = None
    for i in range(checked):
        logs = one_step(i, start + i)
        losses.append(logs['loss'])
        if i == 0:
            grad1 = prog.first_grad_norms()
    change = torch.stack([(p.detach() - q).float().norm() for p, q in
                          zip(prog.params(), prog.p0)]).cpu()
    losses = [float(v) for v in losses]
    del prog.p0
    if ctx.get('readings_only'):
        out = dict(named_shapes=prog.named_shapes, kept=kept,
                   program=dict(losses=losses, grad1=grad1, change=change))
        spans.remove()
        del prog, step_fn, batches, logs
        gc.collect()
        if is_cuda:
            torch.cuda.empty_cache()
        return out
    seen = {shape_key(b) for b in batches[:checked]}
    i = checked
    for j in range(checked, len(batches)):
        if shape_key(batches[j]) not in seen:
            seen.add(shape_key(batches[j]))
            one_step(j, start + i)
            i += 1
    order_start = i
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    bsz = batches[0]['image'].shape[0]
    out = dict(setup_s=setup_s)
    idx = order_start
    if args.trace:
        n_steps = int(mix['trace_steps'])
        # the timing pass (trace.py): the window, the device's busy time,
        # each step's host time and the steps that the FLOPs count
        spans.enabled = False
        host = []
        light = trace.device_profiler(is_cuda)
        with light:
            w0 = time.perf_counter()
            for n in range(n_steps):
                t = time.perf_counter()
                logs = one_step(idx, start + idx)
                host.append(time.perf_counter() - t)
                idx += 1
                if (n + 1) % interval == 0:
                    float(logs['loss'])
            if is_cuda:
                torch.cuda.synchronize()
            window = time.perf_counter() - w0
        timed = list(range(order_start, idx))
        # the attribution pass: spans, host ops and the ops' shapes
        spans.enabled = True
        attributed = idx
        prof = trace.profiler()
        with prof:
            with spans('window'):
                for n in range(n_steps):
                    logs = one_step(idx, start + idx)
                    idx += 1
                    if (n + 1) % interval == 0:
                        float(logs['loss'])
                if is_cuda:
                    torch.cuda.synchronize()
        rec = trace.read_trace(prof)
        rec.update(window_s=window, busy_s=trace.device_busy(light),
                   host_s=dict(step=host))
        out.update(records=rec, steps=n_steps, images=n_steps * bsz,
                   timed_batches=[k % len(batches) for k in timed],
                   attributed_batches=[k % len(batches) for k in
                                       range(attributed, idx)],
                   attempted=2 * n_steps, failed=0)
    else:
        events = []
        first = torch.cuda.Event(enable_timing=True) if is_cuda else None
        if is_cuda:
            torch.cuda.synchronize()
            first.record()
        w0 = time.perf_counter()
        n = failed = 0
        while time.perf_counter() - w0 < args.seconds:
            logs = one_step(idx, start + idx)
            idx += 1
            n += 1
            if is_cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            else:
                events.append(time.perf_counter())
            if n % interval == 0:
                failed += interval * (not math.isfinite(float(logs['loss'])))
        if is_cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - w0
        out.update(steps=n, images=n * bsz, window_s=window, attempted=n,
                   failed=failed)
        if is_cuda:
            out['step_ms'] = [first.elapsed_time(events[0])] + [
                a.elapsed_time(b) for a, b in zip(events, events[1:])]
        else:
            ends = [w0] + events
            out['step_ms'] = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
    out['memory_peak_bytes'] = (torch.cuda.max_memory_allocated()
                                if is_cuda else 0)
    out['named_shapes'] = prog.named_shapes
    out['program'] = dict(losses=losses, grad1=grad1, change=change)
    spans.remove()
    del prog, step_fn, batches, logs
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    out['kept'] = kept
    return out


def p_quantile(values, q: float) -> float:
    """The ``q`` quantile (0-1) of ``values``, linear between order
    statistics (numpy's default)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def check(ctx: Dict, run_out: Dict, device='cuda', tf32_on=False) -> Dict:
    """The reference over the checked batches from the same seeded
    weights; the gaps of ``reference.compare.train_gaps``."""
    from reference import model as RM
    from reference import train as RT
    from reference.compare import train_gaps
    cfg, args = ctx['cfg'], ctx['args']
    names = RM.named_shapes(cfg)
    if names != run_out['named_shapes']:
        raise RuntimeError('the program\'s parameters differ from the '
                           'reference\'s in name or shape')
    weights = seeded_weights(names, args.seed, torch.device(device),
                             cfg['init'])
    batcher = RM.train_batcher(cfg)
    batches = [batcher(samples) for samples in run_out['kept']]
    ref = RT.run_steps(cfg, weights, batches,
                       int(cfg['schedule']['start_step']), device,
                       tf32_on=tf32_on)
    del weights
    gaps = train_gaps(run_out['program'], ref)
    detail = dict(program_losses=run_out['program']['losses'],
                  reference_losses=ref['losses'])
    return dict(gaps=gaps, ref=ref, detail=detail)


def yardstick(ctx: Dict, run_out: Dict, device='cuda') -> Dict:
    """What the traced run's readers take from the frozen reference:
    ``flops``, the convolution and matrix-product FLOPs of forward and
    backward of the timing pass's steps (``FlopCounterMode``, once per
    distinct batch shape), and ``op_inputs``, the counts of the kernels
    that need their inputs' values (``harness.kernels.recorded_inputs``)
    over the attribution pass's batches, in order."""
    from torch.utils.flop_counter import FlopCounterMode
    from reference import model as RM
    from .kernels import recorded_inputs
    cfg, mix, args = ctx['cfg'], ctx['mix'], ctx['args']
    pool = traffic.train_samples(mix, args.seed, cfg['img_norm_cfg'],
                                 _num_classes(cfg['model']),
                                 bool(cfg.get('with_gt_masks', False)))
    batcher = RM.train_batcher(cfg)
    batches = [batcher(samples) for samples in pool]
    names = RM.named_shapes(cfg)
    model = RM.build(cfg, device)
    load_weights(model, seeded_weights(names, args.seed,
                                       torch.device(device), cfg['init']))
    model.train()
    start = int(cfg['schedule']['start_step'])
    by_shape = {}
    for k in run_out['timed_batches']:
        by_shape.setdefault(shape_key(batches[k]), k)
    flops = {}
    params = [p for p in model.parameters() if p.requires_grad]
    for key, k in by_shape.items():
        counter = FlopCounterMode(display=False)
        with counter:
            out = model.loss(RM.to_device(batches[k], device), start)
            total = sum(v for name, v in out.items() if 'loss' in name)
            torch.autograd.grad(total, params, allow_unused=True)
        flops[key] = counter.get_total_flops()

    def attributed():
        with torch.no_grad():
            for k in run_out['attributed_batches']:
                model.loss(RM.to_device(batches[k], device), start)

    op_inputs = recorded_inputs(run_out['records']['op_calls'], attributed)
    del model
    return dict(flops=float(sum(flops[shape_key(batches[k])]
                                for k in run_out['timed_batches'])),
                op_inputs=op_inputs)


def end_to_end(run_out: Dict) -> Dict[str, float]:
    return dict(
        train_images_per_s=run_out['images'] / run_out['window_s'],
        train_step_p90_ms=p_quantile(run_out['step_ms'], 0.9),
        setup_s=run_out['setup_s'])
