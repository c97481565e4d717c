"""The port's spans and counters (``utils.profiling``) on the CPU.

- the clock: each span's ``bis:`` event of a CPU ``torch.profiler`` run lies
  inside the interval its recorder stamped with ``time.time_ns()``, a few
  microseconds in at the median;
- off means off: with no profiler and no recorder a span is one shared
  no-op that records nothing;
- the tree: one tiny BoxInst step, one tiny Box2Mask step (the tiny configs
  of the parity tests) and one tiny Box2Mask ``predict_batch`` +
  ``format_detection`` open the documented spans, in order, under the
  documented parents;
- ``count`` lands under the innermost open span, a count from another
  thread under the recording thread's, and every count in ``COUNTS``;
  ``self_ns`` is a span's time less its children's.

The host syncs are counted on the card alone (``tests/test_torch_cuda.py``).
"""
import statistics
import threading

import numpy as np
import torch

import test_torch_threads  # noqa: F401  (one torch thread)
from test_box2mask_model import synth_batch as b2m_batch, \
    tiny_cfg as b2m_cfg
from test_torch_slice import make_batch as boxinst_batch, \
    tiny_cfg as boxinst_cfg

from boxinstseg_tpu_torch.apis.test import format_detection, predict_batch
from boxinstseg_tpu_torch.apis.train import batch_to_device
from boxinstseg_tpu_torch.engine.train_state import make_train_step
from boxinstseg_tpu_torch.registry import build_detector
from boxinstseg_tpu_torch.utils import profiling as P


def _tree(rec):
    """(name, parent name) of each span, in the order they opened."""
    return [(s.name, rec.spans[s.parent].name if s.parent >= 0 else None)
            for s in rec.spans]


def test_span_events_lie_inside_their_recorded_interval():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with P.record() as rec:
            for i in range(100):
                with P.span(f's{i}'):
                    torch.ones(8).add_(1)
    events = {e.name()[len(P.PREFIX):]: e
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(P.PREFIX)}
    assert len(events) == len(rec.spans) == 100
    begin, end = [], []
    for s in rec.spans:
        e = events[s.name]
        begin.append(e.start_ns() - s.begin_ns)
        end.append(s.end_ns - e.end_ns())
    assert min(begin) >= 0 and min(end) >= 0
    assert statistics.median(begin) < 50_000
    assert statistics.median(end) < 50_000


def test_span_is_a_shared_noop_when_nothing_listens():
    assert P._recorder is None
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = P.span('a'), P.span('b')
    assert a is b
    with a:
        P.count('test.off')
    with P.record() as rec:
        pass
    assert rec.spans == [] and not rec.counts
    assert P._recorder is None


def _sgd(model):
    params = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.SGD([dict(params=params, lr_mult=1.0)], lr=0.01,
                           momentum=0.9)


def _recorded_step(model, batch):
    step = make_train_step(model, _sgd(model), lambda i: 0.01,
                           dict(max_norm=10.0))
    with P.record() as rec:
        step(batch_to_device(batch, 'cpu'), 0)
    return rec


UPDATE = [('backward', 'step'), ('grad_norm', 'step'),
          ('optimizer', 'step')]


def test_boxinst_step_records_its_spans_in_order():
    torch.manual_seed(0)
    model = build_detector(boxinst_cfg())
    rec = _recorded_step(model, boxinst_batch(0))
    assert _tree(rec) == [
        ('batch_to_device', None), ('step', None),
        ('forward.backbone', 'step'), ('forward.neck', 'step'),
        ('forward.bbox_head', 'step'), ('forward.mask_head', 'step'),
        ('forward.mask_branch', 'step'), ('loss', 'step'),
        ('loss.targets', 'loss'), ('loss.box', 'loss'),
        ('loss.mask', 'loss')] + UPDATE
    # each step's spans share the step's index as their root
    assert {s.root for s in rec.spans[1:]} == {1}
    assert all(s.end_ns >= s.begin_ns > 0 for s in rec.spans)


def _b2m_model():
    torch.manual_seed(0)
    return build_detector(b2m_cfg())


def test_box2mask_step_records_its_spans_in_order():
    batch = {k: np.asarray(v) for k, v in
             b2m_batch(np.random.RandomState(0)).items()}
    rec = _recorded_step(_b2m_model(), batch)
    assert _tree(rec) == [
        ('batch_to_device', None), ('step', None),
        ('forward.backbone', 'step'), ('forward.panoptic_head', 'step'),
        ('loss', 'step'), ('loss.mst', 'loss'), ('loss.match', 'loss'),
        ('loss.layers', 'loss'), ('loss.tree_filter', 'loss'),
        ('loss.levelset', 'loss')] + UPDATE


def test_predict_and_format_record_their_spans_in_order():
    model = _b2m_model().eval()
    rng = np.random.RandomState(0)
    batch = dict(image=rng.rand(1, 64, 96, 3).astype(np.float32),
                 img_shape=np.array([[60, 90]], np.int32),
                 scale_factor=np.ones((1, 4), np.float32))
    with P.record() as rec:
        out = predict_batch(model, batch, False)
        det = format_detection(out, 0, (60, 90), (120, 180),
                               dict(model.test_cfg))
    assert len(det.masks) == len(det.labels)
    assert _tree(rec) == [
        ('predict', None), ('batch_to_device', 'predict'),
        ('forward.backbone', 'predict'), ('forward.panoptic_head', 'predict'),
        ('postprocess', 'predict'), ('format', None),
        ('format.copy_out', 'format'), ('format.resize', 'format'),
        ('format.copy_out', 'format'), ('format.copy_out', 'format')]
    assert [s.root for s in rec.spans] == [0] * 5 + [5] * 5


def test_count_lands_under_the_innermost_span():
    before = P.COUNTS['test.k']
    with P.record() as rec:
        with P.span('a'):
            P.count('test.k', 2)
            with P.span('b'):
                P.count('test.k')
                worker = threading.Thread(target=P.count, args=('test.t',))
                worker.start()
                worker.join(timeout=10)
                assert not worker.is_alive()
        P.count('test.k')
    a, b = rec.spans
    assert a.counts == {'test.k': 2}
    assert b.counts == {'test.k': 1, 'test.t': 1}
    assert rec.counts == {'test.k': 4, 'test.t': 1}
    assert P.COUNTS['test.k'] == before + 4
    own = rec.self_ns()
    assert own['b'] == b.end_ns - b.begin_ns
    assert own['a'] == (a.end_ns - a.begin_ns) - own['b']


