#!/usr/bin/env python
"""Timing-only variants of the one-block-a-tile pairwise kernels (K1 / K2 in
``tools/baselines/pairwise_tiles.cu``, the design that ``csrc/pairwise.cu``
replaced), on one GPU:

    python3 tools/diagnose_pairwise_kernels.py

``tools/baselines/pairwise_variants.cu`` holds the variants: as shipped;
the colour gates a constant (no sim reads); empty tiles skipped; the
transcendentals replaced by cheap arithmetic (wrong values); the copy floor
(read the logits and the bitmask, write one partial a block or one plane).
Each is timed twice (CUDA events, 20 calls after 3 warm-up) beside its
error against the plain version, at two input sets of the main path's
shape (2, 64, 200, 336): ``chip_smoke.py``'s random inputs (a bitmask half
ones, every tile live) and the inputs of the last pairwise call of the
smoke's BoxInst slice (5 SGD steps at full width: box bitmasks, the
synthetic images' colour gates). For each set it prints the coverage
(``chip_smoke.pairwise_coverage``), then times the one-block-a-tile
kernels through their C entries and this tree's kernels through theirs,
in turns (the kernels' device time; the wrappers' time beside it).
Last, this tree's kernels with an empty bitmask (what every block does
before it finds work), and at each tile height (8, 16 rows) and instances
a block (1-32, the same for K1 and K2): copies of ``csrc/pairwise.cu``
with its ``TILE_H``, ``CHUNK_FORWARD`` and ``CHUNK_BACKWARD`` set so,
written to and built in ``boxinstseg_tpu_torch/_build/pairwise_plans/``.
After the build it prints what ``nvcc -Xptxas -v`` says of
``csrc/pairwise.cu``'s kernels.
Prints the card's nvidia-smi line first.
"""
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MODES = ((0, 'as shipped'), (1, 'gates a constant (no sim reads)'),
         (2, 'empty tiles skipped'),
         (3, 'transcendentals cheap (wrong values)'),
         (4, 'copy floor (wrong values)'))
TILE_ROWS = (8, 16)
CHUNKS = (1, 2, 4, 8, 16, 32)


def build():
    import chip_smoke as cs
    from boxinstseg_tpu_torch.ops import _native
    variants = os.path.join(ROOT, 'tools', 'baselines',
                            'pairwise_variants.cu')
    _native.build_all(['pairwise', variants, cs.BASELINES['pairwise']])
    lib = _native.load_library(variants)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.pairwise_fwd_variant, lib.pairwise_bwd_variant):
        fn.argtypes = [i] + [p] * 6 + [i] * 7 + [ctypes.c_float, p]
        fn.restype = i
    return lib, cs.load_baseline('pairwise')


def build_plans():
    """{(tile rows, chunk): library} of csrc/pairwise.cu at each plan of the
    sweep, its C entries typed as the package's."""
    from boxinstseg_tpu_torch.ops import _native
    from boxinstseg_tpu_torch.ops import pairwise as pw
    with open(os.path.join(_native.CSRC_DIR, 'pairwise.cu')) as f:
        source = f.read()
    out_dir = os.path.join(_native.BUILD_DIR, 'pairwise_plans')
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for rows in TILE_ROWS:
        for chunk in CHUNKS:
            text = source
            for name, value in (('TILE_H', rows), ('CHUNK_FORWARD', chunk),
                                ('CHUNK_BACKWARD', chunk)):
                text, n = re.subn(rf'constexpr int {name} = \d+;',
                                  f'constexpr int {name} = {value};', text)
                if n != 1:
                    raise RuntimeError(f'no one constant {name} in '
                                       f'csrc/pairwise.cu')
            path = os.path.join(out_dir, f'pairwise_t{rows}_c{chunk}.cu')
            with open(path, 'w') as f:
                f.write(text)
            paths[rows, chunk] = path
    _native.build_all(list(paths.values()))
    typed = pw._lib()
    libs = {}
    for plan, path in paths.items():
        lib = libs[plan] = _native.load_library(path)
        for fn in ('pairwise_forward', 'pairwise_backward',
                   'pairwise_forward_blocks', 'pairwise_live_items'):
            getattr(lib, fn).argtypes = getattr(typed, fn).argtypes
            getattr(lib, fn).restype = getattr(typed, fn).restype
    return libs


def ptxas_report():
    """Registers, shared memory and spills of csrc/pairwise.cu's kernels
    (nvcc -Xptxas -v)."""
    from boxinstseg_tpu_torch.ops import _native
    flags = [f for f in _native.NVCC_FLAGS if f not in ('-shared',
                                                         '-Xcompiler',
                                                         '-fPIC')]
    out = subprocess.run(
        [_native._nvcc(), *flags, '-Xptxas', '-v', '-c', '-o', os.devnull,
         os.path.join(_native.CSRC_DIR, 'pairwise.cu')],
        capture_output=True, text=True).stderr
    for line in out.splitlines():
        if 'Compiling entry' in line or 'registers' in line or \
                'spill' in line:
            print(line.strip())


def input_sets():
    import torch
    import chip_smoke as cs
    gen = torch.Generator(device='cuda').manual_seed(0)
    sets = {'random': cs.kernel_inputs(cs.MAIN_SHAPE, gen)}
    cs.register_dataset()
    _, kept = cs.phase_slice(cs.load_train_tool())
    sets['main path'] = kept['inputs']
    return sets


def diagnose(lib, baseline, plans, name, x, sim, bm, valid):
    import torch
    import chip_smoke as cs
    from boxinstseg_tpu_torch.ops import pairwise as pw
    print(f'-- {name} inputs')
    cs.pairwise_coverage(x, sim, bm, valid)
    b, k, h, w = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    one = torch.ones(1, device='cuda')
    tiles = baseline.baseline_pairwise_tiles(h, w)
    part = torch.empty((2, b, k, tiles), device='cuda')
    grad = torch.empty_like(x)
    args = [t.data_ptr() for t in (x, sim, bm, valid)]
    cfg = (b, k, h, w, 8, 1, 2, 0.3, stream)

    def fwd(mode):
        err = lib.pairwise_fwd_variant(mode, *args, part[0].data_ptr(),
                                       part[1].data_ptr(), *cfg)
        if err:
            raise RuntimeError(f'pairwise_fwd_variant: CUDA error {err}')
        return part.sum(dim=(1, 2, 3))

    def bwd(mode):
        err = lib.pairwise_bwd_variant(mode, *args, one.data_ptr(),
                                       grad.data_ptr(), *cfg)
        if err:
            raise RuntimeError(f'pairwise_bwd_variant: CUDA error {err}')
        return grad
    num, den = pw.pairwise_num_den_plain(x, sim, bm, valid)
    want_g = pw.pairwise_grad_plain(x, sim, bm, valid)
    for mode, what in MODES:
        got = fwd(mode)
        f_err = abs(got[0].item() - num.item()) / max(abs(num.item()), 1)
        g_err = (bwd(mode) - want_g).abs().max().item()
        f_ms = [cs.cuda_ms(lambda: fwd(mode)) for _ in range(2)]
        b_ms = [cs.cuda_ms(lambda: bwd(mode)) for _ in range(2)]
        print(f'{what}: K1 {f_ms[0]:.4f} / {f_ms[1]:.4f} ms (num rel err '
              f'{f_err:.3g}), K2 {b_ms[0]:.4f} / {b_ms[1]:.4f} ms (grad '
              f'max abs err {g_err:.3g})')
    old_f, old_b = cs.pairwise_baseline(baseline, x, sim, bm, valid, one)
    new_f, new_b = cs.pairwise_entries(x, sim, bm, valid, one)
    cs.in_turns('K1, one block a tile against this tree', old_f, new_f)
    cs.in_turns('K2, one block a tile against this tree', old_b, new_b)
    f_ms = cs.cuda_ms(lambda: pw.pairwise_forward_cuda(x, sim, bm, valid))
    b_ms = cs.cuda_ms(lambda: pw.pairwise_grad_cuda(x, sim, bm, valid, one))
    print(f'this tree through the wrappers: K1 {f_ms:.4f} ms, K2 '
          f'{b_ms:.4f} ms')
    new_f, new_b = cs.pairwise_entries(x, sim, torch.zeros_like(bm), valid,
                                       one)
    print(f'this tree with an empty bitmask (the vote, the zero stores and '
          f'the sum alone): K1 {cs.cuda_ms(new_f):.4f} ms, K2 '
          f'{cs.cuda_ms(new_b):.4f} ms')
    for (rows, chunk), plan in plans.items():
        new_f, new_b = cs.pairwise_entries(x, sim, bm, valid, one, plan)
        print(f'this tree, tiles of {rows} x 32, {chunk} instances a block: '
              f'K1 {cs.cuda_ms(new_f):.4f} ms, K2 {cs.cuda_ms(new_b):.4f} ms')


def main():
    import torch
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib, baseline = build()
    plans = build_plans()
    ptxas_report()
    for name, inputs in input_sets().items():
        diagnose(lib, baseline, plans, name, *inputs)


if __name__ == '__main__':
    main()
