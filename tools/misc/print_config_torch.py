#!/usr/bin/env python
"""Print the fully-resolved config with the PyTorch port's ``Config``, the
counterpart of ``tools/misc/print_config.py`` (CONFIG positional +
--cfg-options; ${key} interpolation and legacy migrations applied exactly
as tools/train_torch.py does)."""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))


def main(argv=None):
    p = argparse.ArgumentParser(description='Print the whole config')
    p.add_argument('config', help='config file path')
    p.add_argument('--cfg-options', nargs='+', default=[],
                   help='override config, format key=value')
    args = p.parse_args(argv)

    from boxinstseg_tpu_torch.config import (Config, compat_cfg,
                                             replace_cfg_vals)
    cfg = compat_cfg(replace_cfg_vals(Config.fromfile(args.config)))
    overrides = {}
    for kv in args.cfg_options:
        k, v = kv.split('=', 1)
        overrides[k] = v
    cfg.merge_from_dict(overrides)
    print(repr(cfg))
    return cfg


if __name__ == '__main__':
    main()
