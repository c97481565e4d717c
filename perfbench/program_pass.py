"""Run one benchmark cell's program pass and print what the port's own
spans and counters read there.

    python3 perfbench/program_pass.py --workload <cell> --seed <n>

The cell is built as ``run.py`` builds it (the port's train step or its
predict and format, the seeded weights, the seeded pool; set-up recorded
by the port's recorder, so that its ``build_detector`` span is kept), and
every pool entry runs once. Then, over the same ``trace_steps`` /
``trace_images`` entries of the pool: the timing pass (``harness/
trace.py``: the device's activity alone, the host clock), the attribution
pass (host ops and the harness's spans; its blocking runtime calls are
counted), then ``ROUNDS`` times the program pass (``harness/program.py``:
the timing pass's profiler and the port's recorder with its host syncs)
and the timing pass in turns. The first program pass is the one read; the
turns measure its cost, since the first profiled pass of a process runs
slower than the later ones, whatever they record. ``run.py`` does not make the
program pass yet: its readers (``perfbench/metrics``, the names in
``READERS``) read the records this script makes under ``program`` and
``setup``.

Standard error gets the program pass's records (``program.report``);
standard output one JSON line: the readers' values, the median window
of the program passes over the later timing passes' (the recording's
cost), the clock check
(kernels that began before the span their launch fell in), the host syncs
and the attribution pass's blocking runtime calls a step, and the card.
Exits 2 without a CUDA card.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import common  # noqa: E402

ROUNDS = 3          # program passes and later timing passes, in turns

READERS = {
    'train_boxes': (
        'backward_device_ms.train', 'optimizer_device_ms.train',
        'forward_idle_ms.train', 'loss_idle_ms.train',
        'update_idle_ms.train', 'host_syncs.train', 'launches.train',
        'build_detector_s'),
    'predict_images': (
        'predict_idle_ms.predict', 'format_idle_ms.predict',
        'host_syncs.predict', 'launches.predict', 'build_detector_s'),
}


def _train_cell(ctx, dev, spans):
    """(one(k): the k-th step of the pool in the harness's spans, the
    pool's size)."""
    from boxinstseg_tpu_torch.apis.train import batch_to_device
    from harness import train
    cfg, mix, seed = ctx['cfg'], ctx['mix'], ctx['args'].seed
    prog = train.Program(cfg, dev, seed, spans)
    batches, _ = train.pool_batches(cfg, mix, seed, train.port_batcher(cfg))
    start = int(cfg['schedule']['start_step'])

    def one(k):
        with spans('batch_to_device'):
            batch = batch_to_device(batches[k % len(batches)], dev)
        with spans('step'):
            prog.step_fn(batch, start + k)
    return one, len(batches)


def _predict_cell(ctx, dev, spans):
    """(one(k): predict and format of the k-th image of the pool in the
    harness's spans, the pool's size)."""
    import torch
    from boxinstseg_tpu_torch.apis.test import (eval_batcher,
                                                format_detection,
                                                predict_batch)
    from boxinstseg_tpu_torch.apis.train import apply_precision_policy
    from boxinstseg_tpu_torch.registry import build_detector
    from boxinstseg_tpu_torch.utils.env import set_tf32
    import boxinstseg_tpu_torch.models  # noqa: F401  (registers)
    from harness import traffic
    from harness.predict import _port_cfg
    from harness.weights import load_weights, seeded_weights
    cfg, mix, seed = ctx['cfg'], ctx['mix'], ctx['args'].seed
    pcfg = _port_cfg(cfg)
    set_tf32(bool(cfg.get('tf32', False)))
    bf16 = apply_precision_policy(pcfg)
    with torch.device(dev):
        model = build_detector(pcfg.model.copy())
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    load_weights(model, seeded_weights(shapes, seed, dev, cfg['init']))
    model.eval()
    spans.hook_children(model)
    test_cfg = dict(pcfg.model.get('test_cfg', {}) or {})
    if pcfg.model.get('panoptic_fusion_head'):
        test_cfg['panoptic_fusion'] = dict(pcfg.model['panoptic_fusion_head'])
    batcher = eval_batcher(pcfg)
    samples = traffic.predict_images(mix, seed, cfg['img_norm_cfg'])
    batches = [batcher([s]) for s in samples]

    def one(k):
        smp = samples[k % len(samples)]
        with spans('predict'):
            out = predict_batch(model, batches[k % len(batches)], bf16)
        with spans('format'):
            format_detection(out, 0, smp['img_shape'][:2],
                             smp['ori_shape'][:2], test_cfg)
    return one, len(batches)


def run(ctx, device='cuda'):
    """The records of the three passes over one cell (see the module
    docstring): ``program`` (``program.read``), ``setup``
    (``build_detector_s``, the set-up's counts), the timing pass's
    ``window_s`` and ``busy_s``, the windows of the later program and
    timing passes (``windows``), and the attribution pass's records
    (``trace.read_trace``, under ``attribution``, with ``steps``) and
    ``blocking_calls``."""
    import torch
    from boxinstseg_tpu_torch.utils.profiling import record
    from harness import program, trace
    dev = torch.device(device)
    is_cuda = dev.type == 'cuda'
    kind = ctx['mix']['kind']
    n = int(ctx['mix']['trace_steps' if kind == 'train_boxes'
                       else 'trace_images'])

    def finish():
        if is_cuda:
            torch.cuda.synchronize()

    spans = trace.Spans(True)
    with record() as setup:
        one, pool = (_train_cell if kind == 'train_boxes'
                     else _predict_cell)(ctx, dev, spans)
        spans.enabled = False
        for k in range(pool):
            one(k)
        finish()
    # each pass starts at a multiple of the pool: the same entries in the
    # same order
    stride = pool * math.ceil(n / pool)

    def timed(first):
        prof = trace.device_profiler(is_cuda)
        with prof:
            w0 = time.perf_counter()
            for k in range(first, first + n):
                one(k)
            finish()
            window = time.perf_counter() - w0
        return window, trace.device_busy(prof)

    window, busy = timed(stride)
    spans.enabled = True
    prof = trace.profiler()
    with prof:
        with spans('window'):
            for k in range(2 * stride, 2 * stride + n):
                one(k)
            finish()
    spans.enabled = False
    attributed = program.events_of(prof)
    attribution = dict(trace.read_trace(prof), steps=n)
    # then the program pass and the timing pass in turns: the first
    # profiled pass of a process runs slower than the later ones, whatever
    # they record
    prog, windows = None, dict(program=[], timing=[])
    for r in range(ROUNDS):
        done = program.program_pass(one, (3 + 2 * r) * stride, n, is_cuda,
                                    finish)
        prog = prog or done
        windows['program'].append(done.get('window_s'))
        windows['timing'].append(timed((4 + 2 * r) * stride)[0])
    spans.remove()
    return dict(
        program=prog, window_s=window, busy_s=busy, windows=windows,
        attribution=attribution,
        setup=dict(build_detector_s=setup.total_ns('build_detector') * 1e-9,
                   counts=dict(setup.counts)),
        blocking_calls={k: attributed['calls'][k] for k in program.BLOCKING
                        if k in attributed['calls']} if attributed else {})


def summary(ctx, rec):
    """The JSON line's fields (see the module docstring)."""
    prog = rec['program']
    n = max(prog['steps'], 1)
    metrics = {name: common.load_reader(name)(rec)
               for name in READERS[ctx['mix']['kind']]}
    if rec['attribution'] and ctx['mix']['kind'] == 'train_boxes':
        metrics['update_device_ms.train'] = common.load_reader(
            'update_device_ms.train')(rec['attribution'])
    out = dict(workload=ctx['work']['name'], seed=ctx['args'].seed,
               metrics=metrics,
               timing_window_s=rec['window_s'],
               timing_idle_share=(1 - rec['busy_s'] / rec['window_s'])
               if rec['window_s'] > 0 else None,
               setup_counts=rec['setup']['counts'],
               counts_a_step={k: v / n for k, v in prog['counts'].items()},
               sync_sites=prog['sync_sites'],
               attributed_blocking_calls_a_step={
                   k: v / n for k, v in rec['blocking_calls'].items()})
    if 'window_s' in prog:
        out.update(
            windows=rec['windows'],
            on_cost=statistics.median(rec['windows']['program'])
            / statistics.median(rec['windows']['timing']),
            program_idle_ms_a_step=1e3 * (prog['window_s'] - prog['busy_s'])
            / n,
            early_kernels=prog['early_kernels'],
            unlaunched=prog['unlaunched'],
            program_blocking_calls_a_step={
                k: v / n for k, v in prog['blocking_calls'].items()},
            device_ms_a_step={k: 1e3 * v / n for k, v in sorted(
                prog['device_s'].items(), key=lambda kv: -kv[1])},
            idle_ms_a_step={k: 1e3 * v / n for k, v in sorted(
                prog['idle_s'].items(), key=lambda kv: -kv[1])})
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Run one cell\'s program pass.')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    common.set_cache_dirs()
    ctx = common.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 2
    ctx.update(args=args, t0=T0)
    from harness import program
    rec = run(ctx, 'cuda')
    program.report(rec['program'])
    out = summary(ctx, rec)
    out['device'] = torch.cuda.get_device_name(0)
    common.check_no_jax()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
