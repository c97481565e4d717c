"""Readings for the limits of a train cell's check, in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds N \
        --control 3 --faults 3 [--first-seed S] [--out FILE]

For each of N seeds the program's checked steps (the run's own set-up,
without the warm-up and the window) against the reference: the sound
readings. For the first ``--control`` seeds the control, the reference
itself with TF32 on (the precision below the configuration's fp32 with
TF32 off), against the reference. For the first ``--faults`` seeds the
program with half of each batch left out (the mean over the rest). A
step that leaves the state unchanged reads ``update_gap`` 1 by its
definition and needs no run. Prints one JSON line a reading."""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import common  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, default=12)
    p.add_argument('--control', type=int, default=3)
    p.add_argument('--faults', type=int, default=3)
    p.add_argument('--first-seed', type=int, default=3000000019)
    p.add_argument('--device', default='cuda')
    p.add_argument('--seconds', type=float, default=3.0)
    p.add_argument('--out', default=None)
    a = p.parse_args()
    common.set_cache_dirs()
    ctx = common.cell(a.workload)
    sink = open(a.out, 'a') if a.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + '\n')
            sink.flush()

    if ctx['mix']['kind'] == 'train_boxes':
        train_readings(a, ctx, emit)
    else:
        predict_readings(a, ctx, emit)


def train_readings(a, ctx, emit):
    import torch
    from harness import train
    from reference.compare import train_gaps
    for k in range(a.seeds):
        seed = a.first_seed + 7919 * k
        c = dict(ctx, args=argparse.Namespace(seed=seed, seconds=0,
                                              trace=0),
                 t0=time.perf_counter(), readings_only=True)
        out = train.run(c, a.device)
        chk = train.check(c, out, a.device)
        emit(dict(kind='program', seed=seed, **chk['gaps'],
                  losses=out['program']['losses'],
                  ref_losses=chk['ref']['losses']))
        if k < a.control:
            ctl = train.check(c, out, a.device, tf32_on=True)
            gaps = train_gaps(dict(losses=ctl['ref']['losses'],
                                   grad1=ctl['ref']['grad1'],
                                   change=ctl['ref']['change']), chk['ref'])
            emit(dict(kind='control_tf32', seed=seed, **gaps))
        if k < a.faults:
            f = train.run(c, a.device, fault='half_batch')
            fchk = train.check(c, f, a.device)
            emit(dict(kind='fault_half_batch', seed=seed, **fchk['gaps']))
        if a.device == 'cuda':
            torch.cuda.empty_cache()


def predict_readings(a, ctx, emit):
    """The program over a short window of ``--seconds`` (every pool image
    met at least once), its sampled results against the reference; the
    control: the reference with TF32 on against the reference; the faults
    'altered_few', 'duplicated' (``harness.predict.plant``) and
    'attention_inverted'."""
    from harness import predict
    for k in range(a.seeds):
        seed = a.first_seed + 7919 * k
        c = dict(ctx, args=argparse.Namespace(seed=seed, seconds=a.seconds,
                                              trace=0),
                 t0=time.perf_counter())
        out = predict.run(c, a.device)
        chk = predict.check(c, out, a.device)
        emit(dict(kind='program', seed=seed, images=len(out['kept']),
                  **chk['gaps']))
        if k < a.control:
            emit(dict(kind='control_tf32', seed=seed,
                      **predict.control(c, out, a.device)))
        for fault in ('altered_few', 'duplicated', 'attention_inverted') \
                if k < a.faults else ():
            f = predict.run(c, a.device, fault=fault)
            emit(dict(kind='fault_' + fault, seed=seed,
                      **predict.check(c, f, a.device)['gaps']))


if __name__ == '__main__':
    main()
