#!/usr/bin/env python
"""Convert PASCAL VOC XML annotations to a COCO-style instance json with
the PyTorch port's class list, the counterpart of
``tools/dataset_converters/pascal_voc.py`` (the same devkit layout and
split semantics, COCO json out).

Layout expected: VOCdevkit/VOC{year}/{Annotations,JPEGImages,ImageSets}.
"""
import argparse
import json
import os
import sys
import xml.etree.ElementTree as ET

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

from boxinstseg_tpu_torch.data.coco import VOC_CLASSES  # noqa: E402

LABEL_IDS = {name: i + 1 for i, name in enumerate(VOC_CLASSES)}


def parse_xml(xml_path):
    root = ET.parse(xml_path).getroot()
    size = root.find('size')
    w = int(size.find('width').text)
    h = int(size.find('height').text)
    objs = []
    for obj in root.findall('object'):
        name = obj.find('name').text
        if name not in LABEL_IDS:
            continue
        difficult = int(obj.find('difficult').text
                        if obj.find('difficult') is not None else 0)
        bb = obj.find('bndbox')
        # VOC is 1-indexed inclusive; convert to 0-indexed xywh
        x1 = float(bb.find('xmin').text) - 1
        y1 = float(bb.find('ymin').text) - 1
        x2 = float(bb.find('xmax').text) - 1
        y2 = float(bb.find('ymax').text) - 1
        objs.append(dict(category_id=LABEL_IDS[name],
                         bbox=[x1, y1, x2 - x1, y2 - y1],
                         area=(x2 - x1) * (y2 - y1),
                         iscrowd=0, ignore=difficult))
    return w, h, objs


def convert_split(devkit, year, split, out_file):
    voc = os.path.join(devkit, f'VOC{year}')
    ids_file = os.path.join(voc, 'ImageSets', 'Main', f'{split}.txt')
    with open(ids_file) as f:
        img_ids = [line.split()[0] for line in f if line.strip()]
    images, annotations = [], []
    ann_id = 1
    for i, stem in enumerate(img_ids):
        w, h, objs = parse_xml(os.path.join(voc, 'Annotations',
                                            f'{stem}.xml'))
        images.append(dict(id=i + 1, file_name=f'{stem}.jpg',
                           width=w, height=h))
        for o in objs:
            annotations.append(dict(id=ann_id, image_id=i + 1, **o))
            ann_id += 1
    cats = [dict(id=i + 1, name=n) for i, n in enumerate(VOC_CLASSES)]
    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    with open(out_file, 'w') as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=cats), f)
    print(f'{split} VOC{year}: {len(images)} images, '
          f'{len(annotations)} instances -> {out_file}')


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Convert PASCAL VOC annotations to COCO-style json')
    p.add_argument('devkit_path', help='VOCdevkit root')
    p.add_argument('-o', '--out-dir', default=None,
                   help='output dir (default devkit_path/annotations)')
    p.add_argument('--years', nargs='+', default=['2007', '2012'])
    p.add_argument('--splits', nargs='+',
                   default=['train', 'val', 'trainval', 'test'])
    args = p.parse_args(argv)
    out_dir = args.out_dir or os.path.join(args.devkit_path, 'annotations')
    for year in args.years:
        for split in args.splits:
            ids = os.path.join(args.devkit_path, f'VOC{year}', 'ImageSets',
                               'Main', f'{split}.txt')
            if not os.path.exists(ids):
                continue
            convert_split(args.devkit_path, year, split,
                          os.path.join(out_dir,
                                       f'voc{year}_{split}_cocostyle.json'))


if __name__ == '__main__':
    main()
