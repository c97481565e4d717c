#!/usr/bin/env python
"""Prepare a PyTorch-port checkpoint for release, the counterpart of
``tools/model_converters/publish_model.py`` (reference: mmdet's
tools/model_converters/publish_model.py).

    python tools/model_converters/publish_model_torch.py \
        work_dirs/run/iter_90000.pth boxinst_r50_1x.pth

Reads a ``.pth`` that ``apis.train.train_detector`` wrote, drops the
optimizer state and the teacher-student state (the EMA teacher, the object
bank, ``avg_loss_ins``) and the step counter, keeps the model's
``state_dict`` (on the CPU) and ``meta``, and writes them to
``<out>-<sha256[:8]>.pth``, the first 8 hex digits of the written file's
sha256, as mmdet names published models. ``init_detector`` reads it. Host
only.
"""
import argparse
import hashlib
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description='Process a checkpoint to be published (PyTorch port)')
    p.add_argument('in_file', help='.pth checkpoint from training')
    p.add_argument('out_file', help='output filename (.pth)')
    return p.parse_args(argv)


def main(argv=None):
    """Returns the published file's path."""
    args = parse_args(argv)
    import torch
    ckpt = torch.load(args.in_file, map_location='cpu', weights_only=False)
    if 'state_dict' not in ckpt:
        raise KeyError(f'{args.in_file} holds no state_dict')
    keep = {'state_dict': {k: v.cpu() for k, v in
                           ckpt['state_dict'].items()},
            'meta': dict(ckpt.get('meta') or {})}
    stem = args.out_file[:-len('.pth')] if args.out_file.endswith('.pth') \
        else args.out_file
    tmp = f'{stem}.pth.tmp'
    torch.save(keep, tmp)
    with open(tmp, 'rb') as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    final = f'{stem}-{sha[:8]}.pth'
    os.replace(tmp, final)
    print(f'{args.in_file} ({len(keep["state_dict"])} tensors; dropped '
          f'{sorted(set(ckpt) - set(keep))}) -> {final}')
    return final


if __name__ == '__main__':
    main()
