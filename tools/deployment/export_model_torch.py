#!/usr/bin/env python
"""Export a detector's predict with ``torch.export``, the PyTorch port's
counterpart of ``tools/deployment/export_model.py`` (which serialises
StableHLO with ``jax.export``).

    python tools/deployment/export_model_torch.py CONFIG [CHECKPOINT] \
        --output-file model.pt2 [--shape 800 1344] [--batch 1] [--device cpu]

The program takes (image (B, 3, H, W) normalised, img_shape (B, 2) int32,
scale_factor (B, 4)) at the one static canvas ``--shape`` and batch
``--batch``, with the weights baked in (random from seed 0 when no
checkpoint is given), and returns ``predict``'s dict. The MSDA and Swin
kernels stay in the graph as the ops ``boxinstseg::msda_forward`` and
``boxinstseg::window_attention``: a program exported on the card runs the
kernels there. Load it with ``torch.export.load`` after importing
``boxinstseg_tpu_torch`` (which registers the ops);
``tools/deployment/test_torch.py`` evaluates it. A config with a precision
key (bf16 autocast) raises naming the key. ``--device`` is ``cuda`` by
default (and raises without a card).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='Export a detector with torch.export (PyTorch port)')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None,
                   help='.pth checkpoint; random weights from seed 0 when '
                        'omitted')
    p.add_argument('--output-file', default='model.pt2')
    p.add_argument('--shape', type=int, nargs=2, default=[800, 1344],
                   help='static input canvas (h w); export one program '
                        'per canvas you serve')
    p.add_argument('--batch', type=int, default=1)
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config, format key=value')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    return p.parse_args(argv)


def main(argv=None):
    """Export and save; returns a dict with the program, the eager model
    it came from, the export seconds, the file's bytes and the
    ``boxinstseg::`` op counts."""
    args = parse_args(argv)
    import torch
    from boxinstseg_tpu_torch.apis.export import count_ops, export_predict
    from boxinstseg_tpu_torch.apis.inference import (init_detector,
                                                     load_config,
                                                     select_device)

    device = select_device(args.device)
    cfg = load_config(args.config, args.cfg_options)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model, cfg = init_detector(cfg, args.checkpoint, device=device)
    t0 = time.perf_counter()
    program = export_predict(model, cfg, tuple(args.shape), args.batch)
    seconds = time.perf_counter() - t0
    torch.export.save(program, args.output_file)
    size = os.path.getsize(args.output_file)
    ops = count_ops(program)
    h, w = args.shape
    b = args.batch
    print(f'inputs : image ({b}, 3, {h}, {w}) float32, img_shape ({b}, 2) '
          f'int32, scale_factor ({b}, 4) float32 on {device}')
    print(f'exported in {seconds:.3f} s -> {args.output_file} '
          f'({size / 1e6:.3f} MB)')
    print('boxinstseg ops: ' + (', '.join(f'{k} {v}' for k, v in
                                          sorted(ops.items())) or 'none'))
    print('reload : import boxinstseg_tpu_torch; '
          'torch.export.load(path).module()(image, img_shape, scale_factor)')
    return dict(program=program, model=model, seconds=seconds, bytes=size,
                ops=ops)


if __name__ == '__main__':
    main()
