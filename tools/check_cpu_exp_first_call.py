#!/usr/bin/env python
"""Whether the first ``torch.exp`` of a process on the CPU gives the same
values as the calls after it.

    python3 tools/check_cpu_exp_first_call.py [--runs 40]

Each run is a fresh Python process that computes the pairwise loss's pair
probabilities ``exp(a - logaddexp(a, b))`` of a (2, 8, 32, 48) input
(``tests/test_torch_pairwise.py``'s first shape, seed 0), once and again,
and counts the elements that differ. The input has 24,576 elements, so the
call is split over the CPU threads. Three cases, ``--runs`` processes
each: ``cold`` (this exp is the process's first), ``warm`` (one
single-threaded ``torch.exp`` first) and ``package`` (``import
boxinstseg_tpu_torch`` first, which makes that call). Prints, for each
case, how many runs differed, and each distinct outcome with its count:
the differing elements, their largest relative error and the range of
flat indices they span. CPU only; no JAX.
"""
import argparse
import collections
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_run(case):
    import numpy as np
    if case == 'package':
        sys.path.insert(0, ROOT)
        import boxinstseg_tpu_torch  # noqa: F401
    import torch
    import torch.nn.functional as F
    if case == 'warm':
        torch.exp(torch.zeros(8))
    rng = np.random.RandomState(0)
    x = torch.tensor((rng.randn(2, 8, 32, 48) * 2).astype(np.float32))
    lf, lb = F.logsigmoid(x), F.logsigmoid(-x)
    a = lf + F.pad(lf, (2,) * 4)[..., 0:32, 0:48]
    b = lb + F.pad(lb, (2,) * 4)[..., 0:32, 0:48]
    d = a - torch.logaddexp(a, b)
    first, second = torch.exp(d), torch.exp(d)
    diff = (first - second).abs().reshape(-1)
    bad = (diff > 0).nonzero().reshape(-1)
    rel = float((diff / second.reshape(-1)).max())
    span = f'{bad[0].item()}-{bad[-1].item()}' if bad.numel() else '-'
    print(f'{bad.numel()} {rel:.3g} {span} {torch.get_num_threads()}')


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--runs', type=int, default=40)
    parser.add_argument('--one', choices=('cold', 'warm', 'package'),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        one_run(args.one)
        return
    import torch
    print(f'torch {torch.__version__}, {torch.get_num_threads()} threads',
          flush=True)
    for case in ('cold', 'warm', 'package'):
        outcomes = collections.Counter(
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--one', case], capture_output=True, text=True,
                           check=True).stdout.strip()
            for _ in range(args.runs))
        differed = sum(n for out, n in outcomes.items()
                       if not out.startswith('0 '))
        print(f'{case}: {differed} of {args.runs} runs differed', flush=True)
        for out, n in sorted(outcomes.items()):
            count, rel, span, threads = out.split()
            print(f'  {n} x: {count} elements differ, max rel {rel}, flat '
                  f'indices {span}, {threads} threads', flush=True)


if __name__ == '__main__':
    main()
