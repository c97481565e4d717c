#!/usr/bin/env python
"""Training entry point of the PyTorch / CUDA port (``boxinstseg_tpu_torch``).

Mirrors ``tools/train.py``: CONFIG positional, --work-dir, --cfg-options,
--seed, plus --device (cuda by default, cpu for small runs on a host without
a GPU). One process on one device; the weights are initialised from the
seed (pretrained backbones are not loaded yet).

    python tools/train_torch.py configs/boxinst/boxinst_r50_fpn_1x_coco.py \
        --work-dir work_dirs/boxinst_torch --cfg-options runner.max_iters=5
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train a detector (PyTorch port)')
    p.add_argument('config', help='config file path')
    p.add_argument('--work-dir', help='dir to save logs and checkpoints')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config, format key=value')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    return p.parse_args(argv)


def load_config(path, cfg_options=(), work_dir=None, seed=0):
    """Config with --cfg-options merged, work_dir and seed set."""
    from boxinstseg_tpu_torch.config import (Config, compat_cfg,
                                             replace_cfg_vals)
    cfg = compat_cfg(replace_cfg_vals(Config.fromfile(path)))
    cfg.merge_from_dict(dict(kv.split('=', 1) for kv in cfg_options))
    if work_dir:
        cfg.work_dir = work_dir
    elif not cfg.get('work_dir'):
        cfg.work_dir = os.path.join(
            './work_dirs', os.path.splitext(os.path.basename(path))[0])
    cfg.seed = seed
    return cfg


def build_model(cfg, seed):
    """The detector with its random init drawn from ``seed``."""
    import torch
    from boxinstseg_tpu_torch.registry import build_detector
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_detector(cfg.model.copy())


def main(argv=None):
    """Run the training; returns ``apis.train.TrainResult``."""
    args = parse_args(argv)
    import torch
    if args.device == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('--device cuda: no CUDA device is available')
    from boxinstseg_tpu_torch.registry import build_dataset
    from boxinstseg_tpu_torch.apis.train import train_detector

    cfg = load_config(args.config, args.cfg_options, args.work_dir,
                      args.seed)
    model = build_model(cfg, args.seed)
    dataset = build_dataset(cfg.data['train'])
    return train_detector(model, dataset, cfg, device=args.device)


if __name__ == '__main__':
    main()
