#!/usr/bin/env python
"""Time the port's MSDA kernel pair against an earlier per-level pair, per
encoder layer, on one GPU.

    python tools/compare_msda_torch.py --old-source OLD_MSDA_CU

``OLD_MSDA_CU`` is a ``csrc/msda.cu`` of the per-level interface (one
launch per level: ``msda_forward(value, loc_x, loc_y, weight, out, BH, H,
W, C, L, P, stream)`` and the matching ``msda_backward``), for example
``git show <rev>:boxinstseg_tpu_torch/csrc/msda.cu`` of a revision before
the layer pair. It is built with the package's nvcc flags into the
package's build directory. "Old" is that pair with the module's per-level
glue around it (``ms_deform_attn_plain`` with the old kernels as its
sampler: per level a copy of value, the locations, the P-major weights,
one output, and the sum); "new" is ``ms_deform_attn`` (one launch each
way). Both run at one layer of Box2Mask's pixel decoder (chip_smoke.py's
MSDA inputs), with autograd, in turns (old, new, new, old, old, new):
CUDA events over ``--iters`` calls after 3 warm-up, the forward from the
layer's inputs to its (B, L, heads * D) output, the backward through
``torch.autograd.grad`` of a kept graph. Prints the card's nvidia-smi line,
the largest differences between the two and each turn's times.
"""
import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_old(source):
    from boxinstseg_tpu_torch.ops import _native
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    out = os.path.join(_native.BUILD_DIR, 'libmsda_old_per_level.so')
    subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, '-o', out, source],
                   check=True)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msda_forward.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.msda_backward.argtypes = [p] * 9 + [i] * 6 + [p]
    return lib


def old_function(lib):
    """The per-level pair as an autograd.Function with the per-level
    sampler's signature (value, loc_x, loc_y, weight, num_points)."""
    import torch

    def stream():
        return torch.cuda.current_stream().cuda_stream

    class OldMSDAFunction(torch.autograd.Function):
        @staticmethod
        def forward(ctx, value, loc_x, loc_y, weight, p):
            ctx.save_for_backward(value, loc_x, loc_y, weight)
            ctx.p = p
            bh, h, w, c = value.shape
            l = loc_x.shape[1] // p
            out = torch.empty((bh, l, c), device=value.device)
            err = lib.msda_forward(value.data_ptr(), loc_x.data_ptr(),
                                   loc_y.data_ptr(), weight.data_ptr(),
                                   out.data_ptr(), bh, h, w, c, l, p,
                                   stream())
            if err:
                raise RuntimeError(f'old msda_forward: CUDA error {err}')
            return out

        @staticmethod
        def backward(ctx, g):
            value, loc_x, loc_y, weight = ctx.saved_tensors
            g = g.contiguous()
            bh, h, w, c = value.shape
            l = loc_x.shape[1] // ctx.p
            d_value = torch.zeros_like(value)
            d_lx, d_ly, d_w = (torch.empty_like(loc_x) for _ in range(3))
            err = lib.msda_backward(
                value.data_ptr(), loc_x.data_ptr(), loc_y.data_ptr(),
                weight.data_ptr(), g.data_ptr(), d_value.data_ptr(),
                d_lx.data_ptr(), d_ly.data_ptr(), d_w.data_ptr(), bh, h, w,
                c, l, ctx.p, stream())
            if err:
                raise RuntimeError(f'old msda_backward: CUDA error {err}')
            return d_value, d_lx, d_ly, d_w, None

    return OldMSDAFunction


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--old-source', required=True)
    parser.add_argument('--iters', type=int, default=20)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit('compare_msda_torch: needs a CUDA device')
    import chip_smoke as cs
    from boxinstseg_tpu_torch.ops import msda
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    old = old_function(build_old(args.old_source))
    gen = torch.Generator(device='cuda').manual_seed(1)
    levels = cs.MSDA_LEVELS
    value, ref, offsets, attn, grad = cs.msda_layer_inputs(
        cs.MSDA_B, cs.MSDA_HEADS, cs.MSDA_D, cs.MSDA_P, levels, None, 0, gen)
    leaves = [t.clone().requires_grad_(True) for t in (value, offsets, attn)]

    def old_sampler(*args):
        # the per-level wrapper made each argument contiguous
        return old.apply(*(t.contiguous() for t in args[:4]), args[4])

    calls = {
        'old': lambda: msda.ms_deform_attn_plain(
            leaves[0], levels, ref, leaves[1], leaves[2],
            sample=old_sampler),
        'new': lambda: msda.ms_deform_attn(leaves[0], levels, ref,
                                           leaves[1], leaves[2])}
    outs = {k: f() for k, f in calls.items()}
    grads = {k: torch.autograd.grad(o, leaves, grad, retain_graph=True)
             for k, o in outs.items()}
    print(f'old vs new: output max diff '
          f'{(outs["old"] - outs["new"]).abs().max().item():.3g}; grads '
          f'(value, offsets, attn) max diff ' + ', '.join(
              f'{(a - b).abs().max().item():.3g}'
              for a, b in zip(grads['old'], grads['new'])))
    for who in ('old', 'new', 'new', 'old', 'old', 'new'):
        fwd = cs.cuda_ms(calls[who], args.iters)
        bwd = cs.cuda_ms(lambda: torch.autograd.grad(
            outs[who], leaves, grad, retain_graph=True), args.iters)
        print(f'{who}: forward {fwd:.4f} ms, backward {bwd:.4f} ms a layer')


if __name__ == '__main__':
    main()
