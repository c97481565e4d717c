#!/usr/bin/env python
"""Time the port's window-attention backward (K6) against an earlier
``csrc/swin_attention.cu`` of the same C interface, on one GPU.

    python tools/compare_swin_torch.py --old-source OLD_SWIN_CU [--iters 20]

``OLD_SWIN_CU`` is a ``csrc/swin_attention.cu`` whose
``swin_attention_backward`` takes the same arguments (its ``bias_smem``
argument is the plan's first flag), for example ``git show
<rev>:boxinstseg_tpu_torch/csrc/swin_attention.cu``. It is built twice
with the package's nvcc flags, into two libraries of the package's build
directory: the second ("old copy") is the control, the same code placed in
another module. Prints the card's nvidia-smi line; for the key-tile count
of N = 144 at head dim 32, each library's backward-kernel SASS
(``cuobjdump -sass``: instruction count, and how many instructions differ
from the old build's); then, at Swin-L's stage-0 and stage-2 shapes
(``chip_smoke.py``'s ``SWIN_MAIN``, N = 144, where both sources take the
same plan), whether each gives the old build's bits (dqkv and dbias) and
each one's ms in turns (old, old copy, new, new, old copy, old), twice:
CUDA events over ``--iters`` calls after 3 warm-up.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(source, name):
    """``source`` built into ``lib<name>.so`` of the build directory."""
    from boxinstseg_tpu_torch.ops import _native
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    out = os.path.join(_native.BUILD_DIR, f'lib{name}.so')
    subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, '-o', out, source],
                   check=True)
    lib = ctypes.CDLL(out)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.swin_attention_backward.argtypes = ([p] * 3 + [i] + [p] * 6
                                            + [i] * 5 + [f] + [i] * 2 + [p])
    lib.swin_attention_backward.restype = i
    return lib, out


def backward_sass(path, key_tiles):
    """The instructions (addresses and encodings dropped) of the backward
    kernel's instance for ``key_tiles`` with every operand staged (the
    parent's ``<KT>``, the repair's ``<KT, false, false>``)."""
    from boxinstseg_tpu_torch.ops import _native
    cuobjdump = os.path.join(os.path.dirname(_native._nvcc()), 'cuobjdump')
    text = subprocess.run([cuobjdump, '-sass', path], capture_output=True,
                          text=True, check=True).stdout
    want = re.compile(rf'backward_kernelILi{key_tiles}E(Lb0ELb0E)?E')
    for func in re.split(r'\n\s*Function : ', text):
        if want.search(func.split('\n', 1)[0]):
            return [re.sub(r'/\*[0-9a-f]{4}\*/', '', line).split(';')[0]
                    .strip() for line in func.split('\n')[1:]
                    if re.search(r'/\*[0-9a-f]{4}\*/', line)]
    raise RuntimeError(f'{path}: no backward kernel of {key_tiles} key '
                       f'tiles')


def backward_with(lib, q, k, v, bias, regions, scale, g):
    """K6 of ``lib`` with the wrapper's plan, groups and scratch."""
    import torch
    from boxinstseg_tpu_torch.ops import swin_attention as swa
    bw, n, h, d, nw, ld, plan = swa._check_inputs(q, k, v, bias, regions, g)
    if plan[0] & swa.G_GLOBAL:
        g = swa.padded_heads(g, h)
    groups = swa._groups(q, bw, n, h, plan)
    dqkv = torch.empty((bw, n, 3 * h * d), device=q.device)
    partial = torch.empty((groups, h, n, n), device=q.device)
    dbias = torch.empty((h, n, n), device=q.device)
    err = lib.swin_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, bias.data_ptr(),
        regions.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        partial.data_ptr(), dbias.data_ptr(), bw, n, h, d, nw, float(scale),
        groups, int(plan[0]), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f'swin_attention_backward: CUDA error {err}')
    return dqkv, dbias


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--old-source', required=True)
    p.add_argument('--iters', type=int, default=20)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('compare_swin_torch needs a GPU')
    import chip_smoke as cs
    from boxinstseg_tpu_torch.ops import swin_attention as swa
    from boxinstseg_tpu_torch.utils.env import set_tf32
    set_tf32(False)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = {'old': build(args.old_source, 'swin_attention_old'),
            'old copy': build(args.old_source, 'swin_attention_old_copy')}
    new = swa._lib()
    libs['new'] = (new, new._name)
    kt = swa.key_tiles(144)
    base = backward_sass(libs['old'][1], kt)
    for name, (_, path) in libs.items():
        sass = backward_sass(path, kt)
        differ = sum(a != b for a, b in zip(base, sass)) \
            + abs(len(sass) - len(base))
        print(f'K6 SASS at {kt} key tiles, {name}: {len(sass)} instructions, '
              f'{differ} differ from the old build\'s')
    gen = torch.Generator(device='cuda').manual_seed(3)
    order = ['old', 'old copy', 'new']
    for tag, case in cs.SWIN_MAIN.items():
        qkv, bias, regions, g = cs.swin_inputs(case, gen)
        if qkv.shape[1] != 144:
            continue
        q, k, v = swa._split(qkv)
        scale = case[6] ** -0.5
        run = {name: (lambda lib=lib: backward_with(lib, q, k, v, bias,
                                                    regions, scale, g))
               for name, (lib, _) in libs.items()}
        want = run['old']()
        print(f'K6 {tag}: the old build\'s bits (dqkv, dbias): ' + ', '.join(
            f'{name} {[torch.equal(a, b) for a, b in zip(want, run[name]())]}'
            for name in order[1:]))
        for _ in range(2):
            ms = {name: [] for name in order}
            for name in order + order[::-1]:
                ms[name].append(cs.cuda_ms(run[name], args.iters))
            print(f'K6 {tag} in turns: ' + ', '.join(
                f'{name} ' + ' / '.join(f'{t:.4f}' for t in ms[name])
                for name in order) + ' ms')


if __name__ == '__main__':
    main()
