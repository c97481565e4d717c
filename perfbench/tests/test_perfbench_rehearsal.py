"""Each cell rehearsed end to end on the CPU at a tiny size through the
plain paths (the port's registered ops run their plain versions on CPU
tensors), and the harness's own faults planted in the timed path: each
must turn ``correct`` false under the cell's committed limits."""
import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(1, os.path.dirname(os.path.dirname(HERE)))

import pb_tiny as tiny  # noqa: E402
from harness import common, runner  # noqa: E402

torch.set_num_threads(1)

# the tiny rehearsals compare two fp32 runs of the same plain arithmetic
# on the CPU: they agree to rounding
TIGHT = dict(loss_gap=1e-4, grad_gap=1e-4, update_gap=1e-3,
             mask_box_gap=1e-3, score_gap=1e-4,
             flip_margin=1e-4)


def _ctx(cell, cfg, mix, trace=0, limits=None, seed=2 ** 31 + 11):
    bench = common.benchmark()
    c = tiny.ctx(cfg, mix, seed=seed, trace=trace, seconds=0.3,
                 limits=limits)
    c['work'] = next(w for w in bench['workloads'] if w['name'] == cell)
    c['metrics'] = {k: [m for m in bench[k]
                        if cell in m.get('workloads', [cell])]
                    for k in ('end_to_end', 'per_layer')}
    return c


def _limits(cell, keys):
    path = os.path.join(os.path.dirname(HERE), 'limits', f'{cell}.json')
    with open(path) as f:
        limits = json.load(f)['limits']
    return {k: limits[k] for k in keys}


CELLS = {
    'boxinst_r50_train': (tiny.tiny_boxinst,
                          lambda: tiny.tiny_train_mix('boxinst_multiscale'),
                          ('loss_gap', 'grad_gap', 'update_gap')),
    'box2mask_r50_train': (tiny.tiny_box2mask,
                           lambda: tiny.tiny_train_mix('box2mask_lsj'),
                           ('loss_gap', 'grad_gap', 'update_gap')),
    'box2mask_r50_predict': (tiny.tiny_box2mask, tiny.tiny_predict_mix,
                             ('mask_box_gap', 'score_gap', 'flip_margin')),
}


@pytest.fixture
def few_detections(monkeypatch):
    import reference.compare as C
    monkeypatch.setattr(C, 'COMPARED_DETECTIONS', 5)


@pytest.mark.parametrize('cell', sorted(CELLS))
@pytest.mark.parametrize('trace', [0, 1])
def test_cell_rehearsed(cell, trace, few_detections):
    make_cfg, make_mix, keys = CELLS[cell]
    limits = {k: TIGHT[k] for k in keys}
    result = runner.execute(_ctx(cell, make_cfg(), make_mix(), trace,
                                 limits), 'cpu')
    assert result['correct'], result['checks']
    assert list(result)[-1] == 'checks'
    names = set(result['metrics'])
    if trace:
        assert result['device']['window_s'] > 0
        assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
        assert any(n.startswith('step_host_ms') or n.startswith('format_')
                   for n in names)
    else:
        want = {m['name'] for m in _ctx(cell, make_cfg(), make_mix())[
            'metrics']['end_to_end']}
        assert names == want
        assert all(v['value'] > 0 for v in result['metrics'].values())


FAULTS = [('boxinst_r50_train', 'unchanged'),
          ('boxinst_r50_train', 'half_batch'),
          ('box2mask_r50_train', 'unchanged'),
          ('box2mask_r50_train', 'half_batch'),
          ('box2mask_r50_predict', 'altered'),
          ('box2mask_r50_predict', 'altered_few'),
          ('box2mask_r50_predict', 'duplicated'),
          ('box2mask_r50_predict', 'attention_inverted')]


@pytest.mark.parametrize('cell,fault', FAULTS)
def test_fault_turns_correct_false(cell, fault, few_detections):
    make_cfg, make_mix, keys = CELLS[cell]
    result = runner.execute(_ctx(cell, make_cfg(), make_mix(),
                                 limits=_limits(cell, keys)), 'cpu',
                            fault=fault)
    assert not result['correct'], result['checks']
