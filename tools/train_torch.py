#!/usr/bin/env python
"""Training entry point of the PyTorch / CUDA port (``boxinstseg_tpu_torch``).

Mirrors ``tools/train.py``: CONFIG positional, --work-dir, --resume-from,
--auto-resume, --no-validate, --auto-scale-lr, --cfg-options, --seed,
--launcher, --local_rank, --pretrained-backbone (a local torchvision-format
ResNet ``.pth``), plus --device (cuda by default, cpu for small runs on a
host without a GPU). The weights are initialised from the seed. Without
--no-validate a config with ``data.val`` is evaluated by its
``evaluation`` interval.

One process on one device, or, with ``--launcher pytorch``, one rank of a
data-parallel run that ``torchrun`` launched (``tools/dist_train_torch.sh``)
or, with ``--launcher slurm``, one task of an ``srun`` launch
(``tools/slurm_train_torch.sh``): nccl and the card ``cuda:{LOCAL_RANK}``
with ``--device cuda``, gloo on the CPU with ``--device cpu``.

    python tools/train_torch.py configs/boxinst/boxinst_r50_fpn_1x_coco.py \
        --work-dir work_dirs/boxinst_torch --cfg-options runner.max_iters=5
    tools/dist_train_torch.sh configs/boxinst/boxinst_r50_fpn_1x_coco.py 8
    GPUS=16 tools/slurm_train_torch.sh PARTITION JOB \
        configs/boxinst/boxinst_r50_fpn_1x_coco.py
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
    p.add_argument('--resume-from', help='checkpoint (.pth) to resume from')
    p.add_argument('--auto-resume', action='store_true',
                   help='resume from the newest checkpoint of the work dir')
    p.add_argument('--no-validate', action='store_true',
                   help='do not evaluate during training')
    p.add_argument('--auto-scale-lr', action='store_true',
                   help='enable cfg.auto_scale_lr (linear batch-size LR '
                        'scaling; base_batch_size 16 when the config has '
                        'no auto_scale_lr)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config, format key=value')
    p.add_argument('--pretrained-backbone',
                   help='torchvision-format ResNet .pth to load into the '
                        'backbone')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    add_launcher_args(p)
    return p.parse_args(argv)


def add_launcher_args(p):
    p.add_argument('--launcher', default='none',
                   choices=('none', 'pytorch', 'slurm'),
                   help='pytorch: one rank of a torchrun launch (RANK, '
                        'WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); '
                        'slurm: one task of an srun launch (SLURM_PROCID, '
                        'SLURM_NTASKS, SLURM_LOCALID, with MASTER_ADDR and '
                        'MASTER_PORT exported)')
    p.add_argument('--local_rank', '--local-rank', type=int, default=None,
                   help='this rank\'s card, when the launcher passes it '
                        'instead of LOCAL_RANK')


# --launcher slurm: the variable srun sets for each one that
# parallel/dist.py reads
SLURM_VARS = (('SLURM_PROCID', 'RANK'), ('SLURM_NTASKS', 'WORLD_SIZE'),
              ('SLURM_LOCALID', 'LOCAL_RANK'))


def slurm_environment(env=None):
    """Map an srun task's ``SLURM_PROCID``, ``SLURM_NTASKS`` and
    ``SLURM_LOCALID`` onto ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in
    ``env`` (``os.environ`` by default). Raises ``SystemExit`` naming the
    first of these, or ``MASTER_ADDR``, that is not set: a rank is never
    guessed."""
    env = os.environ if env is None else env
    for name in ('MASTER_ADDR',) + tuple(s for s, _ in SLURM_VARS):
        if not env.get(name):
            raise SystemExit(f'--launcher slurm: {name} is not set')
    for slurm, torch_name in SLURM_VARS:
        env[torch_name] = env[slurm]
    env.setdefault('MASTER_PORT', '29500')
    return env


def launch(args):
    """Join the process group for ``--launcher pytorch`` or ``slurm``
    (nccl for ``--device cuda``, gloo for ``--device cpu``); returns the
    device this process runs on."""
    import torch
    if args.device == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('--device cuda: no CUDA device is available')
    if args.launcher == 'none':
        return torch.device(args.device)
    from boxinstseg_tpu_torch.parallel import dist as pdist
    if args.launcher == 'slurm':
        slurm_environment()
    if args.local_rank is not None:
        os.environ['LOCAL_RANK'] = str(args.local_rank)
    if 'WORLD_SIZE' not in os.environ:
        raise SystemExit('--launcher pytorch: WORLD_SIZE is not set')
    pdist.init_distributed(backend='nccl' if args.device == 'cuda'
                           else 'gloo')
    return pdist.local_device() if args.device == 'cuda' \
        else torch.device('cpu')


def load_config(path, cfg_options=(), work_dir=None, seed=0,
                auto_scale_lr=False):
    """Config with --cfg-options merged, work_dir and seed set, and
    ``auto_scale_lr`` enabled for --auto-scale-lr (``base_batch_size`` 16
    when the config has no ``auto_scale_lr``), as ``tools/train.py``."""
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
    if auto_scale_lr:
        if 'auto_scale_lr' in cfg:
            cfg.auto_scale_lr['enable'] = True
        else:
            cfg.auto_scale_lr = dict(enable=True, base_batch_size=16)
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
    device = launch(args)
    from boxinstseg_tpu_torch.registry import build_dataset
    from boxinstseg_tpu_torch.apis.train import train_detector

    cfg = load_config(args.config, args.cfg_options, args.work_dir,
                      args.seed, args.auto_scale_lr)
    if args.auto_resume:
        cfg.auto_resume = True
    model = build_model(cfg, args.seed)
    if args.pretrained_backbone:
        from boxinstseg_tpu_torch.utils.weights import \
            load_pretrained_backbone
        load_pretrained_backbone(model.backbone, args.pretrained_backbone)
    dataset = build_dataset(cfg.data['train'])
    val_dataset = None
    if not args.no_validate and 'val' in cfg.get('data', {}):
        val_dataset = build_dataset({**cfg.data['val'], 'test_mode': True})
    try:
        return train_detector(model, dataset, cfg, device=device,
                              val_dataset=val_dataset,
                              resume_from=args.resume_from)
    finally:
        from boxinstseg_tpu_torch.parallel import dist as pdist
        pdist.destroy()


if __name__ == '__main__':
    main()
