#!/usr/bin/env python
"""Timing-only variants of the one-block-a-plane LCM (K3) and CRF (K7)
kernels, the design the ring and banded kernels of ``csrc/lcm.cu`` and
``csrc/crf.cu`` replaced, on one GPU:

    python3 tools/diagnose_stencil_kernels.py

``tools/baselines/stencil_variants.cu`` holds the variants: K3 as it was,
with its 8 offsets unrolled, with aff a constant (no L2 reads), and the
adjoint with a single source a pixel (wrong at the edges); K7 as it was,
with kern and thresh constants, and visiting only each plane's target box
(wrong outside it). Each is timed twice (CUDA events, 20 calls after 3
warm-up) at the main path's shapes of ``chip_smoke.py``, beside its error
against the plain version; then the kernels of this tree through their
wrappers. For the K7 inputs it also prints their target coverage and,
round by round, the share of plane-pixels whose 3x3 neighbourhood is
mixed. Last, a sweep of the redesigned kernels' plans (channels a block and
bands for the LCM ring kernel, bands for K7): for each, how many of its
clusters the card runs at once (cudaOccupancyMaxActiveClusters) and its
time at 0, 1 and 10 rounds. Prints the card's nvidia-smi line first.
"""
import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LCM_MODES = ((0, 0, 'forward, one block a plane'),
             (0, 1, 'forward, 8 offsets unrolled'),
             (0, 2, 'forward, unrolled, aff a constant'),
             (1, 0, 'adjoint, one block a plane'),
             (1, 1, 'adjoint, 8 offsets unrolled'),
             (1, 2, 'adjoint, unrolled, aff a constant'),
             (1, 3, 'adjoint, one source a pixel (wrong at the edges)'))
CRF_MODES = ((0, 'one block a plane'), (1, 'kern and thresh constants'),
             (2, 'the target box only'))


def build():
    from boxinstseg_tpu_torch.ops import _native
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    out = os.path.join(_native.BUILD_DIR, 'libstencil_variants.so')
    t0 = time.time()
    subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, '-o', out,
                    os.path.join(ROOT, 'tools', 'baselines',
                                 'stencil_variants.cu')], check=True)
    print(f'build {time.time() - t0:.1f} s')
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lcm_variant.argtypes = [i, i] + [p] * 3 + [i] * 4 + [p, p, i, p]
    lib.crf_variant.argtypes = [i] + [p] * 6 + [i] * 5 + [p]
    return lib


def diagnose_lcm(lib):
    import torch
    import chip_smoke as cs
    from boxinstseg_tpu_torch.ops import lcm
    gen = torch.Generator(device='cuda').manual_seed(2)
    offs, aff, phi, g = cs.lcm_inputs(cs.LCM_MAIN, gen)
    b, c, h, w = phi.shape
    dy = (ctypes.c_int * 8)(*[o[0] for o in offs])
    dx = (ctypes.c_int * 8)(*[o[1] for o in offs])

    def run(transpose, mode, x):
        out = torch.empty_like(x)
        err = lib.lcm_variant(transpose, mode, aff.data_ptr(), x.data_ptr(),
                              out.data_ptr(), b, c, h, w, dy, dx,
                              cs.LCM_ITERS,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'lcm_variant: CUDA error {err}')
        return out
    want = {0: lcm.lcm_forward_plain(aff, phi, offs, cs.LCM_ITERS),
            1: lcm.lcm_adjoint_plain(aff, g, offs, cs.LCM_ITERS)}
    for transpose, mode, name in LCM_MODES:
        x = g if transpose else phi
        err = (run(transpose, mode, x) - want[transpose]).abs().max().item()
        times = [cs.cuda_ms(lambda: run(transpose, mode, x))
                 for _ in range(2)]
        print(f'LCM {name}: {times[0]:.4f} / {times[1]:.4f} ms; max abs '
              f'err against plain {err:.3g}')
    for _ in range(2):
        fwd = cs.cuda_ms(lambda: lcm.lcm_forward_cuda(aff, phi, offs,
                                                      cs.LCM_ITERS))
        adj = cs.cuda_ms(lambda: lcm.lcm_adjoint_cuda(aff, g, offs,
                                                      cs.LCM_ITERS))
        print(f'LCM wrappers (this tree): forward {fwd:.4f}, adjoint '
              f'{adj:.4f} ms')


def diagnose_crf(lib):
    import numpy as np
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from boxinstseg_tpu_torch.ops import crf
    gen = torch.Generator(device='cuda').manual_seed(4)
    rng = np.random.RandomState(4)
    kern, thresh, bin0, targets = cs.crf_inputs(cs.CRF_MAIN, gen, rng)
    b, k, h, w = bin0.shape
    tg = targets > 0
    rows, cols = tg.any(3), tg.any(2)
    box = torch.zeros((b * k, 4), dtype=torch.int32)
    for n in range(b * k):
        r = torch.nonzero(rows.view(b * k, h)[n]).flatten()
        c = torch.nonzero(cols.view(b * k, w)[n]).flatten()
        if len(r):
            box[n] = torch.tensor([r[0], r[-1] + 1, c[0], c[-1] + 1])
    area = ((box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2])).sum().item()
    print(f'K7 inputs: {tg.sum().item()} target pixels of {tg.numel()}; '
          f'target boxes {area} ({area / tg.numel():.3f})')
    for size in (4, 8, 16, 32):
        covered = 0
        for i in range(b):
            for g0 in range(0, k, size):
                rr = rows[i, g0:g0 + size].any(0).nonzero().flatten()
                cc = cols[i, g0:g0 + size].any(0).nonzero().flatten()
                if len(rr):
                    covered += size * ((rr[-1] - rr[0] + 1)
                                       * (cc[-1] - cc[0] + 1)).item()
        print(f'  the union box of {size}-plane groups covers '
              f'{covered / tg.numel():.3f} of the plane-pixels')
    st = bin0
    for it in range(cs.CRF_ITERS):
        pad = F.pad(st, (1, 1, 1, 1))
        nbs = torch.stack([pad[:, :, 1 + oy:1 + oy + h, 1 + ox:1 + ox + w]
                           for oy in (-1, 0, 1) for ox in (-1, 0, 1)])
        mixed = (nbs.amax(0) > 0) & ~(nbs.amin(0) > 0) & tg
        in_group = mixed.view(b, k // 8, 8, h, w).any(2)
        group_tg = tg.view(b, k // 8, 8, h, w).any(2)
        share = in_group.sum().item() / group_tg.sum().item()
        print(f'  round {it}: mixed plane-pixels '
              f'{mixed.float().mean().item():.4f} of all; group-pixels with '
              f'a mixed plane {share:.4f} of the target group-pixels '
              f'(groups of 8)')
        st = crf.crf_mean_field_plain(kern, thresh, st, targets, 1)
    boxes = box.cuda()

    def run(mode):
        out = torch.empty_like(bin0)
        err = lib.crf_variant(mode, kern.data_ptr(), thresh.data_ptr(),
                              bin0.data_ptr(), targets.data_ptr(),
                              boxes.data_ptr(), out.data_ptr(), b, k, h, w,
                              cs.CRF_ITERS,
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'crf_variant: CUDA error {err}')
        return out
    want = crf.crf_mean_field_plain(kern, thresh, bin0, targets,
                                    cs.CRF_ITERS)
    for mode, name in CRF_MODES:
        differ = (run(mode) != want).sum().item()
        times = [cs.cuda_ms(lambda: run(mode)) for _ in range(2)]
        print(f'K7 {name}: {times[0]:.4f} / {times[1]:.4f} ms; {differ} '
              f'pixels differ from plain')
    for _ in range(2):
        ms = cs.cuda_ms(lambda: crf.crf_mean_field_cuda(
            kern, thresh, bin0, targets, cs.CRF_ITERS))
        print(f'K7 wrapper (this tree): {ms:.4f} ms')
    floor = cs.cuda_ms(lambda: torch.mul(bin0, targets))
    print(f'copy floor (read bin0 and targets, write one plane set): '
          f'{floor:.4f} ms')


def sweep_plans():
    import numpy as np
    import torch
    import chip_smoke as cs
    from boxinstseg_tpu_torch.ops import crf, lcm
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device='cuda').manual_seed(2)
    offs, aff, phi, g = cs.lcm_inputs(cs.LCM_MAIN, gen)
    b, c, h, w = phi.shape
    out = torch.empty_like(phi)
    for transpose, x in ((0, phi), (1, g)):
        for G, rows, bands in ((1, 24, 4), (2, 24, 4), (5, 24, 4),
                               (6, 24, 4), (5, 20, 5), (5, 16, 6),
                               (5, 12, 8)):
            def run(rounds):
                err = lcm._lib().lcm_ring(
                    transpose, aff.data_ptr(), x.data_ptr(), out.data_ptr(),
                    b, c, h, w, 2, G, rows, bands, rounds, stream)
                if err:
                    raise RuntimeError(f'lcm_ring: CUDA error {err}')
            clusters = lcm._lib().lcm_ring_clusters(transpose, c, h, w, 2, G,
                                                    rows, bands)
            times = [cs.cuda_ms(lambda: run(n)) for n in (0, 1, 10)]
            print(f'LCM {"adjoint" if transpose else "forward"} {G} '
                  f'channels a block, {bands} bands of {rows}: '
                  f'{b * -(-c // G)} clusters, {clusters} at once; 0 / 1 / '
                  f'10 rounds ' + ' / '.join(f'{t:.4f}' for t in times) +
                  ' ms')
    gen = torch.Generator(device='cuda').manual_seed(4)
    kern, thresh, bin0, targets = cs.crf_inputs(
        cs.CRF_MAIN, gen, np.random.RandomState(4))
    b, k, h, w = bin0.shape
    out = torch.empty_like(bin0)
    for bands in range(2, 9):
        rows = -(-h // bands)

        def run(rounds):
            err = crf._lib().crf_mean_field(
                kern.data_ptr(), thresh.data_ptr(), bin0.data_ptr(),
                targets.data_ptr(), out.data_ptr(), b, k, h, w, rows, bands,
                1, rounds, stream)
            if err:
                raise RuntimeError(f'crf_mean_field: CUDA error {err}')
        clusters = crf._lib().crf_mean_field_clusters(h, w, rows, bands)
        times = [cs.cuda_ms(lambda: run(n)) for n in (0, 1, 10)]
        print(f'K7 {bands} bands of {rows}: {b * -(-k // 8)} clusters, '
              f'{clusters} at once; 0 / 1 / 10 rounds '
              + ' / '.join(f'{t:.4f}' for t in times) + ' ms')


def main():
    import torch
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = build()
    diagnose_lcm(lib)
    diagnose_crf(lib)
    sweep_plans()


if __name__ == '__main__':
    main()
