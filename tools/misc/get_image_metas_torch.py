#!/usr/bin/env python
"""Collect per-image metas (filename, original shape) of a dataset split
with the PyTorch port's data layer and save them as json, the counterpart
of ``tools/misc/get_image_metas.py`` (reference: it saves a .pkl; json
here, the same content)."""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))


def main(argv=None):
    p = argparse.ArgumentParser(description='Collect image metas')
    p.add_argument('config')
    p.add_argument('--dataset', default='test',
                   choices=['train', 'val', 'test'])
    p.add_argument('--out', default='image-metas.json')
    args = p.parse_args(argv)

    from boxinstseg_tpu_torch.config import (Config, compat_cfg,
                                             replace_cfg_vals)
    from boxinstseg_tpu_torch.registry import build_dataset
    cfg = compat_cfg(replace_cfg_vals(Config.fromfile(args.config)))
    dataset = build_dataset({**cfg.data[args.dataset], 'test_mode': True})
    metas = []
    for info in dataset.data_infos:
        metas.append(dict(filename=info['file_name'],
                          ori_shape=(info['height'], info['width'], 3)))
    with open(args.out, 'w') as f:
        json.dump(metas, f)
    print(f'{len(metas)} metas -> {args.out}')
    return metas


if __name__ == '__main__':
    main()
