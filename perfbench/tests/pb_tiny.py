"""Tiny versions of the benchmark's configurations and mixes, for the CPU
rehearsals of ``perfbench/tests``: ResNet-18 at 16-channel heads, a few
classes, small canvases."""
from __future__ import annotations

import argparse
import copy
import json
import os
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def tiny_boxinst():
    cfg = load('configs', 'boxinst_r50_fpn_1x.json')
    m = cfg['model']
    m['backbone'].update(depth=18, init_cfg=None)
    m['neck'].update(in_channels=[64, 128, 256, 512], out_channels=32)
    m['bbox_head'].update(num_classes=4, in_channels=32, feat_channels=32,
                          stacked_convs=1)
    m['mask_branch'].update(in_channels=32, branch_convs=1,
                            branch_channels=8, branch_out_channels=8)
    m['mask_head'].update(in_channels=8, dynamic_channels=4,
                          bbox_head_channels=32, topk_per_img=8)
    cfg.update(canvases=[[128, 192], [192, 128]], gt_buckets=[4, 8], max_gts=8)
    cfg['log_config'] = dict(interval=2)
    return cfg


def tiny_box2mask():
    cfg = load('configs', 'box2mask_r50_lsj.json')
    m = cfg['model']
    m['backbone'].update(depth=18, init_cfg=None)
    h = m['panoptic_head']
    h.update(in_channels=[64, 128, 256, 512], feat_channels=32,
             out_channels=32, num_things_classes=4, num_queries=8,
             tf_size=[16, 16])
    h['pixel_decoder'].update(num_encoder_layers=1,
                              norm_cfg=dict(type='GN', num_groups=8))
    h['transformer_decoder'].update(num_layers=2)
    h['transformer_decoder']['transformerlayers'].update(
        feedforward_channels=32)
    h['transformer_decoder']['transformerlayers']['attn_cfgs'].update(
        embed_dims=32, num_heads=4)
    h['loss_cls']['class_weight'] = [1.0] * 4 + [0.1]
    m['panoptic_fusion_head'].update(num_things_classes=4)
    cfg.update(canvases=[[64, 64]], gt_buckets=[4, 8], max_gts=8)
    cfg['test_pipeline'][1]['img_scale'] = [96, 64]
    m['test_cfg'].update(max_per_image=10)
    cfg['log_config'] = dict(interval=2)
    return cfg


def tiny_train_mix(name):
    mix = load('traffic', f'{name}.json')
    mix.update(pool_batches=4, originals=[[96, 128], [80, 128]],
               instances=dict(mu=1.0, sigma=0.6, min=1, max=6), block=8,
               box_min=8, trace_steps=2)
    if mix['resize'] == 'fit':
        mix.update(long=180, shorts=[128, 112])
    else:
        mix.update(crop=64)
    return mix


def ctx(cfg, mix, seed=2 ** 31 + 7, seconds=0.5, trace=0, limits=None):
    return dict(cfg=copy.deepcopy(cfg), mix=mix, limits=limits or {},
                args=argparse.Namespace(seed=seed, seconds=seconds,
                                        trace=trace),
                t0=time.perf_counter())


def tiny_predict_mix():
    mix = load('traffic', 'coco_test_keepratio.json')
    mix.update(pool_images=4, originals=[[48, 64], [40, 64]], long=96,
               short=64, block=8, checked_images=2, trace_images=3)
    return mix
