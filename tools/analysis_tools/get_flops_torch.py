#!/usr/bin/env python
"""Parameters and forward FLOPs of a detector, the PyTorch port's
counterpart of ``tools/analysis_tools/get_flops.py``.

    python tools/analysis_tools/get_flops_torch.py CONFIG \
        [--shape 800 1344] [--device cpu]

Builds the model (random weights from seed 0), counts its parameters,
and runs ``predict`` once on one zero image at ``--shape`` under
``torch.utils.flop_counter.FlopCounterMode``. That counts convolutions,
matrix products and the registered kernels (``boxinstseg::msda_forward``
and ``boxinstseg::window_attention``, through their flop formulas), and
no elementwise work (activations, norms, sampling, NMS). XLA's
``cost_analysis`` in the JAX tool counts more than that, so its number
and this one are not compared. ``--device`` is ``cuda`` by default (and
raises without a card).
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

COUNTED = ('counts convolutions, matrix products and the registered '
           'kernels (boxinstseg::msda_forward, boxinstseg::window_attention);'
           ' no elementwise work, so it is not comparable with XLA\'s '
           'cost_analysis')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Parameters and FLOPs '
                                            '(PyTorch port)')
    p.add_argument('config')
    p.add_argument('--shape', type=int, nargs=2, default=[800, 1344])
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config, format key=value')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    return p.parse_args(argv)


def count_flops(model, shape, device):
    """(total FLOPs, {op name: FLOPs}) of one ``predict`` on a zero image of
    ``shape`` (h, w), batch 1. Leaves ``model`` in eval mode without
    gradients."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    h, w = shape
    batch = dict(image=torch.zeros((1, 3, h, w), device=device),
                 img_shape=torch.tensor([[h, w]], dtype=torch.int32,
                                        device=device),
                 scale_factor=torch.ones((1, 4), device=device))
    # no parameter requires grad: the counter's module tracker hooks the
    # autograd node of every module input that does, and a parameter's view
    # made under no_grad has none
    model.eval().requires_grad_(False)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.predict(batch)
    by_op = {str(op).split('.')[-1] if 'boxinstseg' not in str(op)
             else str(op): n
             for op, n in counter.get_flop_counts()['Global'].items()}
    return counter.get_total_flops(), by_op


def main(argv=None):
    """Returns dict(params, flops, by_op)."""
    args = parse_args(argv)
    import importlib.util
    from boxinstseg_tpu_torch.apis.inference import select_device
    device = select_device(args.device)
    spec = importlib.util.spec_from_file_location(
        'train_torch', os.path.join(ROOT, 'tools', 'train_torch.py'))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cfg = tool.load_config(args.config, args.cfg_options)
    model = tool.build_model(cfg, 0).to(device)
    params = sum(p.numel() for p in model.parameters())
    flops, by_op = count_flops(model, tuple(args.shape), device)
    h, w = args.shape
    print(f'input shape: (1, 3, {h}, {w}) on {device}')
    print(f'params: {params / 1e6:.3f} M ({params})')
    print(f'forward flops (predict): {flops / 1e9:.3f} GFLOPs; ' + ', '.join(
        f'{k} {v / 1e9:.3f}' for k, v in sorted(by_op.items())))
    print(f'note: {COUNTED}')
    return dict(params=params, flops=flops, by_op=by_op)


if __name__ == '__main__':
    main()
