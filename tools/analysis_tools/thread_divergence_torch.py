#!/usr/bin/env python
"""Where two torch thread counts part ways in a tiny model's training on
the CPU: the one-process reference of ``tests/test_torch_ddp.py`` (a
family's tiny model, 2 SGD steps on its seeded global batch of 2 images).

    python tools/analysis_tools/thread_divergence_torch.py [--family discobox]
        [--threads 1 8]

Each thread count trains in a fresh process (nothing cached from the other
run) under a dispatch mode that keeps the input of every ReLU. The report:
each ReLU whose mask differs between the two runs (an input that changed
sign), with the input's value in both runs beside the largest difference
of that whole input (the summation order's noise there) and its median
size; then the weights that moved most apart after the 2 steps. A mask
that flips where the value lies within that noise is a tie decided by the
summation order, not a fault.
"""
import argparse
import importlib.util
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_ddp_tests():
    """``tests/test_torch_ddp.py`` as a module (its tiny configs, batch
    and ``train_family``)."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        'test_torch_ddp', os.path.join(ROOT, 'tests', 'test_torch_ddp.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(family, threads, out):
    """Train at ``threads`` threads; save each ReLU's input in call order
    and the final weights to ``out``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    td = load_ddp_tests()
    inputs = []

    class KeepReluInputs(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.relu.default:
                inputs.append(args[0].detach().clone())
            return func(*args, **(kwargs or {}))

    state = td.initial_state(family)
    torch.set_num_threads(threads)
    torch.manual_seed(0)
    with KeepReluInputs():
        result = td.train_family(family, state)
    torch.save(dict(relu_inputs=inputs, state=result['state']), out)


def compare(a, b, threads):
    flips = []
    for i, (x, y) in enumerate(zip(a['relu_inputs'], b['relu_inputs'])):
        flip = (x > 0) != (y > 0)
        if flip.any():
            k = tuple(flip.nonzero()[0].tolist())
            flips.append(i)
            print(f'ReLU call {i} of {len(a["relu_inputs"])}, input '
                  f'{tuple(x.shape)}: {int(flip.sum())} of {x.numel()} '
                  f'elements change side; at {k} the input is '
                  f'{x[k].item():.9g} at {threads[0]} thread(s), '
                  f'{y[k].item():.9g} at {threads[1]}; the input\'s largest '
                  f'difference between the runs {(x - y).abs().max():.3g}, '
                  f'its median size {x.abs().median():.3g}')
    if not flips:
        print('no ReLU changes side')
    moved = sorted(((float(np.abs(a['state'][k] - b['state'][k]).max()), k)
                    for k in a['state'] if a['state'][k].dtype.kind == 'f'),
                   reverse=True)[:5]
    print('weights furthest apart after 2 steps: ' + ', '.join(
        f'{k} {d:.3g}' for d, k in moved))
    return flips


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--family', default='discobox',
                   choices=('boxinst', 'box2mask', 'boxlevelset',
                            'discobox'))
    p.add_argument('--threads', type=int, nargs=2, default=[1, 8])
    p.add_argument('--record', nargs=2, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.record:
        record(args.family, int(args.record[0]), args.record[1])
        return None
    import subprocess
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f'{t}.pt') for t in args.threads]
        for t, path in zip(args.threads, paths):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--family', args.family, '--record', str(t),
                            path], check=True)
        runs = [torch.load(path, weights_only=False) for path in paths]
    return compare(*runs, args.threads)


if __name__ == '__main__':
    main()
