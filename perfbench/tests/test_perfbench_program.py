"""The program pass (``harness/program.py``, ``program_pass.py``) on the
CPU at a tiny size, and its reading of a device trace made by hand.

- every reader of the program pass reads a number or None in each tiny
  cell; without a card the device readers and the host syncs read None,
  ``build_detector_s`` a time;
- the harness's own passes keep their records' keys with the port's spans
  in place: a traced tiny run's ``records`` hold exactly the keys they
  held before the port had spans;
- ``program.read`` puts each kernel under the innermost span open at its
  launch, each idle gap under the span open when it began, counts the
  kernels stamped before their span or their launch, reads the device's
  stamps moved later by the largest lead over a launch, and counts the
  blocking runtime calls.
"""
import os
import sys
from types import SimpleNamespace

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(1, os.path.dirname(os.path.dirname(HERE)))

import pb_tiny as tiny  # noqa: E402
import program_pass  # noqa: E402
from harness import common, program  # noqa: E402
from harness import train as htrain  # noqa: E402

from boxinstseg_tpu_torch.utils.profiling import SpanRecord  # noqa: E402

torch.set_num_threads(1)

CELLS = {
    'boxinst_r50_train': (tiny.tiny_boxinst,
                          lambda: tiny.tiny_train_mix('boxinst_multiscale')),
    'box2mask_r50_train': (tiny.tiny_box2mask,
                           lambda: tiny.tiny_train_mix('box2mask_lsj')),
    'box2mask_r50_predict': (tiny.tiny_box2mask, tiny.tiny_predict_mix),
}


def _ctx(cell, trace=1):
    make_cfg, make_mix = CELLS[cell]
    c = tiny.ctx(make_cfg(), make_mix(), seed=2 ** 31 + 19, trace=trace,
                 seconds=0.3)
    c['work'] = next(w for w in common.benchmark()['workloads']
                     if w['name'] == cell)
    return c


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_every_program_reader_reads_a_number_or_none(cell):
    ctx = _ctx(cell)
    rec = program_pass.run(ctx, 'cpu')
    out = program_pass.summary(ctx, rec)
    names = program_pass.READERS[ctx['mix']['kind']]
    assert set(names) <= set(out['metrics'])
    for name in names:
        value = out['metrics'][name]
        assert value is None or isinstance(value, float), (name, value)
    assert out['metrics']['build_detector_s'] > 0
    # no card: no device trace and no sync count
    device = [n for n in names if n != 'build_detector_s']
    assert all(out['metrics'][n] is None for n in device)
    assert rec['program']['steps'] == int(
        ctx['mix'].get('trace_steps', ctx['mix'].get('trace_images')))


# the keys of a traced run's records before the port had spans
TRAIN_KEYS = {'attributed_window_s', 'attributed_busy_s', 'span_device_s',
              'span_host_s', 'span_count', 'op_device_s', 'op_calls',
              'breakdown', 'window_s', 'busy_s', 'host_s'}


def test_the_harness_passes_keep_their_records():
    out = htrain.run(_ctx('boxinst_r50_train'), 'cpu')
    assert set(out['records']) == TRAIN_KEYS
    assert set(out['records']['span_count']) == {
        'window', 'batch_to_device', 'step', 'loss', 'forward.backbone',
        'forward.neck', 'forward.bbox_head', 'forward.mask_branch'}


def _recorder():
    """A hand-made recording: step (0-100) with backward (40-70) inside,
    then format (100-130); times in ns."""
    spans = [SpanRecord('step', -1, 0, 1, 0),
             SpanRecord('backward', 0, 0, 1, 40),
             SpanRecord('format', -1, 2, 1, 100)]
    for s, end in zip(spans, (100, 70, 130)):
        s.end_ns = end
    return SimpleNamespace(spans=spans, thread=1, counts={'host_sync': 3},
                           sync_sites={'a.py:1': 3}, syncs_watched=True)


def test_read_attributes_kernels_and_gaps_to_the_spans():
    events = dict(
        # (start, end, name, correlation id)
        device=[(10, 30, 'k1', 1), (45, 60, 'k2', 2),
                (38, 42, 'k3', 3), (80, 90, 'Memcpy DtoH', 4),
                (110, 115, 'k5', 5)],
        # launches: k3 launched at 41 inside backward but began at 38; k2's
        # id has a second call, after its first
        launch={1: [(5, 'cudaLaunchKernel')],
                2: [(41, 'cudaLaunchKernel'), (42, 'cuLaunchKernel')],
                3: [(41, 'cudaLaunchKernel')],
                4: [(75, 'cudaMemcpyAsync')], 5: [(101, 'cuLaunchKernel')]},
        calls={'cudaStreamSynchronize': 2, 'cudaLaunchKernel': 9})
    rec = program.read(events, _recorder(), 0, 130, 2)
    assert rec['kernels'] == 4 and rec['early_kernels'] == 1
    assert rec['early_sample'] == [[2, 'k3', 'cudaLaunchKernel', 'backward']]
    assert rec['before_launch'] == 1
    assert rec['shared_ids'] == {'cuLaunchKernel + cudaLaunchKernel': 1}
    assert rec['blocking_calls'] == {'cudaStreamSynchronize': 2}
    ns = 1e-9
    assert rec['device_s'] == pytest.approx(
        {'step': 30 * ns, 'backward': 19 * ns, 'format': 5 * ns})
    assert rec['device_under_s']['step'] == pytest.approx(49 * ns)
    # k3 began 3 ns before its launch: every activity is read 3 ns later,
    # so the gaps are 0-13 (step), 33-41 (step), 45-48 and 63-83
    # (backward), 93-113 (step until 100: the gap began under it) and
    # 118-130 (format)
    assert rec['lead_ns'] == 3
    assert rec['idle_s'] == pytest.approx(
        {'step': 41 * ns, 'backward': 23 * ns, 'format': 12 * ns})
    assert rec['idle_under_s']['step'] == pytest.approx(64 * ns)
    assert rec['window_s'] == pytest.approx(130 * ns)
    assert rec['busy_s'] == pytest.approx(54 * ns)
    assert rec['idle_gaps'][0] == ['step', pytest.approx(41 * ns)]
    assert program.read(None, _recorder(), 0, 130, 2)['counts'] == {
        'host_sync': 3}
