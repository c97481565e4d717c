"""One run of a cell after the look for a chip: the entry's run, the
check against the reference, the metrics and the result line's fields.
``run.py`` calls it on the card; the harness's tests call it on the CPU
with a fault planted in the timed path."""
from __future__ import annotations

import math
import sys
from typing import Dict, Optional

import torch

from . import common


def entry_of(mix: dict):
    """The entry a traffic mix drives: ``train_boxes`` the train step,
    ``predict_images`` predict and format."""
    if mix['kind'] == 'train_boxes':
        from . import train as entry
    else:
        from . import predict as entry
    return entry


def execute(ctx: Dict, device='cuda', fault: Optional[str] = None) -> Dict:
    """The result line's fields as a dict (``checks`` last)."""
    from reference.compare import verdict
    entry = entry_of(ctx['mix'])
    args = ctx['args']
    out = entry.run(ctx, device, fault=fault)
    common.check_no_jax()
    checked = entry.check(ctx, out, device)
    gaps = checked['gaps']
    print(f'readings: {checked.get("detail", "")} gaps {gaps}',
          file=sys.stderr)
    correct = verdict(gaps, ctx['limits']) and out['failed'] == 0
    peak = float(ctx['cfg']['peak_tflops']) * 1e12
    metrics = {}
    if device == 'cuda' or torch.device(device).type == 'cuda':
        dev = common.device_info(int(ctx['work']['chips']))
    else:
        dev = dict(platform='cpu', kind='cpu', count=1, memory_peak_bytes=0)
    dev['memory_peak_bytes'] = int(out['memory_peak_bytes'])
    breakdown = None
    if args.trace:
        rec = dict(out['records'])
        rec.update(steps=out['steps'], images=out['images'],
                   peak_flops=peak, **entry.yardstick(ctx, out, device))
        for m in ctx['metrics']['per_layer']:
            value = common.load_reader(m['name'])(rec)
            if value is not None and math.isfinite(value):
                metrics[m['name']] = dict(value=value, unit=m['unit'])
        dev.update(busy_s=rec['busy_s'], window_s=rec['window_s'])
        breakdown = rec['breakdown']
    else:
        values = entry.end_to_end(out)
        for m in ctx['metrics']['end_to_end']:
            metrics[m['name']] = dict(value=values[m['name']],
                                      unit=m['unit'])
    common.check_no_jax()
    result = dict(correct=bool(correct), attempted=int(out['attempted']),
                  failed=int(out['failed']), metrics=metrics, device=dev)
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = common.checks_of(gaps, ctx['limits'])
    return result
