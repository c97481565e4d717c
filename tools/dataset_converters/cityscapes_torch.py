#!/usr/bin/env python
"""Convert Cityscapes gtFine polygon annotations to COCO-style instance
jsons with the PyTorch port's class list, the counterpart of
``tools/dataset_converters/cityscapes.py`` (the *_polygons.json label
files parsed directly, no cityscapesscripts)."""
import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

from boxinstseg_tpu_torch.data.coco import CITYSCAPES_CLASSES  # noqa: E402

LABEL_IDS = {name: i + 1 for i, name in enumerate(CITYSCAPES_CLASSES)}


def _poly_bbox(poly):
    xs = [p[0] for p in poly]
    ys = [p[1] for p in poly]
    x1, y1 = min(xs), min(ys)
    return [x1, y1, max(xs) - x1, max(ys) - y1]


def _poly_area(poly):
    area = 0.0
    for i in range(len(poly)):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % len(poly)]
        area += x1 * y2 - x2 * y1
    return abs(area) / 2


def convert_split(cityscapes_root, split, out_file, img_dir='leftImg8bit'):
    gt_dir = os.path.join(cityscapes_root, 'gtFine', split)
    images, annotations = [], []
    ann_id = 1
    label_files = sorted(glob.glob(
        os.path.join(gt_dir, '*', '*_gtFine_polygons.json')))
    for img_id, lf in enumerate(label_files, 1):
        with open(lf) as f:
            data = json.load(f)
        city = os.path.basename(os.path.dirname(lf))
        stem = os.path.basename(lf).replace('_gtFine_polygons.json', '')
        images.append(dict(
            id=img_id, width=data['imgWidth'], height=data['imgHeight'],
            file_name=os.path.join(city, f'{stem}_{img_dir}.png')))
        for obj in data['objects']:
            label = obj['label']
            iscrowd = 0
            if label.endswith('group'):  # e.g. 'persongroup'
                label = label[:-len('group')]
                iscrowd = 1
            if label not in LABEL_IDS:
                continue
            poly = obj['polygon']
            if len(poly) < 3:
                continue
            seg = [float(v) for pt in poly for v in pt]
            annotations.append(dict(
                id=ann_id, image_id=img_id, category_id=LABEL_IDS[label],
                segmentation=[seg], bbox=_poly_bbox(poly),
                area=_poly_area(poly), iscrowd=iscrowd))
            ann_id += 1
    cats = [dict(id=i + 1, name=n)
            for i, n in enumerate(CITYSCAPES_CLASSES)]
    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    with open(out_file, 'w') as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=cats), f)
    print(f'{split}: {len(images)} images, {len(annotations)} instances '
          f'-> {out_file}')


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Convert Cityscapes gtFine to COCO-style json')
    p.add_argument('cityscapes_path', help='cityscapes root '
                                           '(contains gtFine/, leftImg8bit/)')
    p.add_argument('-o', '--out-dir', default=None,
                   help='output dir (default <root>/annotations)')
    p.add_argument('--splits', nargs='+', default=['train', 'val'])
    args = p.parse_args(argv)
    out = args.out_dir or os.path.join(args.cityscapes_path, 'annotations')
    for split in args.splits:
        convert_split(args.cityscapes_path, split,
                      os.path.join(out,
                                   f'instancesonly_filtered_gtFine_'
                                   f'{split}.json'))


if __name__ == '__main__':
    main()
