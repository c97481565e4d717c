"""The control on a card: the reference itself in the precision below
the configuration's (TF32 on, where the configuration states fp32 with
TF32 off) must fail the cell's committed limits, at the cell's own size
on one seed (``calibrate.py`` reads it on three and more)."""
import argparse
import json
import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
sys.path.insert(0, PB)
sys.path.insert(1, os.path.dirname(PB))

from harness import common  # noqa: E402


def _cells():
    return [w['name'] for w in common.benchmark()['workloads']
            if common.cell(w['name'])['mix']['kind'] == 'train_boxes']


@pytest.mark.cuda
@pytest.mark.parametrize('cell', _cells())
def test_tf32_control_fails_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from harness import train
    from reference.compare import train_gaps, verdict
    ctx = common.cell(cell)
    c = dict(ctx, args=argparse.Namespace(seed=3200000011, seconds=0,
                                          trace=0),
             t0=time.perf_counter(), readings_only=True)
    out = train.run(c, 'cuda')
    ref = train.check(c, out, 'cuda')
    ctl = train.check(c, out, 'cuda', tf32_on=True)['ref']
    gaps = train_gaps(dict(losses=ctl['losses'], grad1=ctl['grad1'],
                           change=ctl['change']), ref['ref'])
    print(json.dumps(gaps))
    assert verdict(ref['gaps'], ctx['limits'])
    assert not verdict(gaps, ctx['limits'])


def _predict_cells():
    return [w['name'] for w in common.benchmark()['workloads']
            if common.cell(w['name'])['mix']['kind'] == 'predict_images']


@pytest.mark.cuda
@pytest.mark.parametrize('cell', _predict_cells())
def test_tf32_control_fails_the_predict_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from harness import predict
    from reference.compare import verdict
    ctx = common.cell(cell)
    c = dict(ctx, args=argparse.Namespace(seed=3200000011, seconds=3.0,
                                          trace=0),
             t0=time.perf_counter())
    out = predict.run(c, 'cuda')
    sound = predict.check(c, out, 'cuda')['gaps']
    gaps = predict.control(c, out, 'cuda')
    print(json.dumps(dict(sound=sound, control=gaps)))
    assert verdict(sound, ctx['limits'])
    assert not verdict(gaps, ctx['limits'])
