#!/usr/bin/env python
"""Train-step time of two trees of the port in turns, on one GPU.

    python tools/compare_steps_torch.py --old-tree DIR [CONFIG ...]
        [--turns 2] [--steps 6] [--warmup 2] [--out DIR]

For each config (BoxLevelset R-50 3x and Box2Mask R-50 LSJ by default),
runs ``tools/profile_train_torch.py`` of the old tree (an unpacked
``git archive`` of an earlier commit) and of this tree in turns (old, new,
new, old for two turns), each in a fresh process that imports only its own
tree. Prints each run's wall ms/step (median, min, max of ``--steps``
untraced steps), the traced steps' device-busy ms and idle share, and the
host ms that each step spends inside the tree filter's ``grid_mst`` call
(the median over every call of the run, warm-up, untraced and traced
steps: the first call builds the kernel or imports scipy), which is how
long the host waits on the tree: the copy to the host, the solve and the
copy back before the kernel, a launch after it.
Ends with one JSON line of every run's numbers; ``--out`` keeps each
run's whole output (its profile table too) in a file of its own.
"""
import argparse
import json
import os
import re
import runpy
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ('configs/boxlevelset/box_levelset_coco_r50_fpn_3x.py',
           'configs/box2mask/box2mask_r50_lsj_8x2_50e_coco.py')
PATTERNS = {
    'wall_ms': r'wall ms/step: median ([\d.]+) \(min ([\d.]+), max ([\d.]+)\)',
    'traced': r'traced steps: wall ([\d.]+) ms/step, device busy ([\d.]+) '
              r'ms/step, idle share ([\d.]+)',
    'mst': r'grid_mst: (\d+) calls, host ms a call ([\d.]+)',
}


def child(tree, config, steps, warmup):
    """In a fresh process: profile ``config`` with ``tree``'s own
    profile_train_torch.py, timing each tree filter ``grid_mst`` call on
    the host clock."""
    sys.path.insert(0, tree)
    import torch
    from boxinstseg_tpu_torch.ops import tree_filter
    inner = tree_filter.grid_mst
    calls = []

    def timed(*args):
        t0 = time.perf_counter()
        out = inner(*args)
        calls.append(1e3 * (time.perf_counter() - t0))
        return out
    tree_filter.grid_mst = timed
    sys.argv = ['profile_train_torch.py', os.path.join(tree, config),
                '--steps', str(steps), '--warmup', str(warmup), '--top', '15',
                '--kernels', 'grid_mst']
    runpy.run_path(os.path.join(tree, 'tools', 'profile_train_torch.py'),
                   run_name='__main__')
    torch.cuda.synchronize()
    print(f'grid_mst: {len(calls)} calls, host ms a call '
          f'{statistics.median(calls):.4f}', flush=True)


def run(tree, config, steps, warmup, log=None):
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), '--child', tree, config,
         '--steps', str(steps), '--warmup', str(warmup)],
        capture_output=True, text=True, cwd=tree)
    if log:
        with open(log, 'w') as f:
            f.write(out.stdout + out.stderr)
    if out.returncode != 0:
        raise SystemExit(f'{tree} {config}: exit {out.returncode}\n'
                         f'{out.stdout[-3000:]}\n{out.stderr[-3000:]}')
    got = {}
    for key, pat in PATTERNS.items():
        m = re.search(pat, out.stdout)
        if m is None:
            raise SystemExit(f'{tree} {config}: no "{key}" line in\n'
                             f'{out.stdout[-3000:]}')
        got[key] = [float(v) for v in m.groups()]
    return dict(wall_median=got['wall_ms'][0], wall_min=got['wall_ms'][1],
                wall_max=got['wall_ms'][2], traced_ms=got['traced'][0],
                busy_ms=got['traced'][1], idle=got['traced'][2],
                mst_calls=int(got['mst'][0]), mst_host_ms=got['mst'][1])


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('configs', nargs='*', default=list(CONFIGS))
    p.add_argument('--old-tree', help='an unpacked earlier tree of the repo')
    p.add_argument('--turns', type=int, default=2)
    p.add_argument('--steps', type=int, default=6)
    p.add_argument('--warmup', type=int, default=2)
    p.add_argument('--out', help='a directory for each run\'s output')
    p.add_argument('--child', nargs=2, metavar=('TREE', 'CONFIG'),
                   help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        child(*args.child, args.steps, args.warmup)
        return
    if not args.old_tree:
        p.error('--old-tree is required')
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    trees = {'old': os.path.abspath(args.old_tree), 'new': ROOT}
    order = []
    for t in range(args.turns):
        order += ['old', 'new'] if t % 2 == 0 else ['new', 'old']
    results = []
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for config in args.configs:
        for i, which in enumerate(order):
            log = args.out and os.path.join(
                args.out, f'{os.path.basename(config)[:-3]}_{i}_{which}.txt')
            r = run(trees[which], config, args.steps, args.warmup, log)
            r.update(config=os.path.basename(config), tree=which)
            results.append(r)
            print(f'{r["config"]} {which}: wall ms/step median '
                  f'{r["wall_median"]:.3f} (min {r["wall_min"]:.3f}, max '
                  f'{r["wall_max"]:.3f}); traced {r["traced_ms"]:.3f}, busy '
                  f'{r["busy_ms"]:.3f}, idle share {r["idle"]:.3f}; '
                  f'grid_mst {r["mst_calls"]} calls, '
                  f'{r["mst_host_ms"]:.4f} host ms a call (median)',
                  flush=True)
    print(json.dumps({'card': smi, 'runs': results}))


if __name__ == '__main__':
    main()
