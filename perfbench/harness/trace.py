"""Spans from the benchmark's own files and the reading of a profiler
trace.

Spans are ``torch.profiler.record_function`` ranges named ``pb:<name>``,
opened by the harness around its calls into the program (a step, the
batch's copy, ``model.loss``, a predict call, a format call) and by
forward hooks on the detector's top-level children (``pb:forward.<child>``).
A traced run makes two passes over the same number of steps or images.
The timing pass records the device's activity alone (``device_profiler``:
no host ops, no shapes, no spans), so that the profiler adds little host
work to a host-paced window: the window, the device's busy time in it
(``device_busy``) and the harness's host clock around each call come from
it. The attribution pass records host ops with their shapes and the
spans (``profiler``); ``read_trace`` turns it into the records of the
device time by span and by registered op, the ops' shapes and the
breakdown:

- every device activity (kernel, copy, set) as an interval; the device is
  busy in their union (the arithmetic of ``busy_ms`` in the repo's train
  profiler);
- each activity's launch, through the runtime call's correlation id, with
  its time and thread: it belongs to the innermost span open on the
  harness's thread at that time (the backward's launches, made by the
  autograd thread while the harness's thread waits inside a span, go to
  that span), and to a registered op (``boxinstseg::...``) when the launch
  lies inside that op's range on the launching thread;
- the idle gaps between busy intervals inside the traced window, labelled
  by the innermost span and host op open on the harness's thread when the
  gap began.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
from collections import defaultdict
from typing import Dict, List, Optional

import torch

PREFIX = 'pb:'


class Spans:
    """The harness's spans; ``enabled`` False makes every span a no-op
    (it is read at each call, so the hooks stay in place between the
    passes)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.handles = []

    def __call__(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def hook_children(self, model: torch.nn.Module) -> None:
        """A ``pb:forward.<child>`` span around each call of each top-level
        child of ``model``; none in a run without a trace."""
        if not self.enabled:
            return
        for name, child in model.named_children():
            label = f'{PREFIX}forward.{name}'
            open_ = []

            def pre(mod, args, label=label, open_=open_):
                if not self.enabled:
                    return
                rf = torch.profiler.record_function(label)
                rf.__enter__()
                open_.append(rf)

            def post(mod, args, out, open_=open_):
                if open_:
                    open_.pop().__exit__(None, None, None)

            self.handles.append(child.register_forward_pre_hook(pre))
            self.handles.append(child.register_forward_hook(post))

    def wrap_method(self, obj, method: str, name: str) -> None:
        """Wrap ``obj.method`` on the instance in a ``pb:<name>`` span; not
        in a run without a trace."""
        if not self.enabled:
            return
        inner = getattr(obj, method)

        def wrapped(*args, **kwargs):
            with self(name):
                return inner(*args, **kwargs)

        setattr(obj, method, wrapped)

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


def profiler():
    """The attribution pass's profiler: host ops with their shapes, the
    spans and the device's activity."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        record_shapes=True)


def device_profiler(is_cuda: bool):
    """The timing pass's profiler: the device's activity alone (on the
    CPU, where there is none, no profiler)."""
    if not is_cuda:
        return contextlib.nullcontext()
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def device_busy(prof) -> float:
    """Seconds in which a device activity (kernel, copy, set) ran: the
    union of their intervals in ``device_profiler``'s run; 0 without
    one."""
    if not isinstance(prof, torch.profiler.profile):
        return 0.0
    from torch.autograd import DeviceType
    return union_length([
        (e.start_ns() * 1e-9, e.end_ns() * 1e-9)
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA
        and not e.is_user_annotation() and not e.name().startswith(PREFIX)])


def union_length(intervals: List[tuple]) -> float:
    """Length of the union of (start, end) intervals (the repo's
    ``busy_ms``)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: List[tuple]) -> List[tuple]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class _Ranges:
    """Nested (start, end, name) ranges of one thread: the innermost one
    open at a time."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def innermost(self, t: float) -> Optional[tuple]:
        i = bisect.bisect_right(self.starts, t)
        best = None
        # walk back over ranges that began earlier; nested ranges begin
        # later than their parents, so the first that contains t is the
        # innermost, save for siblings that closed before t
        for j in range(i - 1, max(i - 4000, -1), -1):
            s, e, _ = self.ranges[j][:3]
            if e >= t:
                best = self.ranges[j]
                break
        return best


def read_trace(prof, main_thread: Optional[int] = None) -> Dict:
    """The records of one profiler run (see the module docstring); times
    in seconds."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    device, cpu_ops, runtime = [], [], {}
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(PREFIX) or e.is_user_annotation():
                continue
            device.append((e.start_ns() * 1e-9, e.end_ns() * 1e-9, name,
                           e.correlation_id()))
        elif e.linked_correlation_id() > 0:
            runtime[e.correlation_id()] = (e.start_ns() * 1e-9,
                                           e.start_thread_id())
        else:
            cpu_ops.append((e.start_ns() * 1e-9, e.end_ns() * 1e-9, name,
                            e.start_thread_id(), e.shapes(), e.dtypes()))
    if main_thread is None:
        spans = [o for o in cpu_ops if o[2].startswith(PREFIX)]
        main_thread = spans[0][3] if spans else threading.get_ident()
    spans = _Ranges([o[:3] for o in cpu_ops
                     if o[2].startswith(PREFIX) and o[3] == main_thread])
    main_ops = _Ranges([o[:3] for o in cpu_ops if o[3] == main_thread
                        and not o[2].startswith(PREFIX)])
    op_ranges = defaultdict(list)
    op_calls = defaultdict(list)
    last_end = {}
    for o in sorted(c for c in cpu_ops if c[2].startswith('boxinstseg::')):
        op_ranges[o[3]].append(o[:3])
        key = (o[3], o[2])
        if o[0] < last_end.get(key, -1.0):
            continue            # the same op's inner record of one call
        last_end[key] = o[1]
        op_calls[o[2]].append((o[4], o[5]))
    op_ranges = {t: _Ranges(r) for t, r in op_ranges.items()}

    windows = [r for r in spans.ranges if r[2] == PREFIX + 'window']
    w0 = windows[0][0] if windows else min(d[0] for d in device)
    w1 = windows[-1][1] if windows else max(d[1] for d in device)
    inside = [d for d in device if d[1] > w0 and d[0] < w1]
    clipped = [(max(d[0], w0), min(d[1], w1)) for d in inside]

    span_device = defaultdict(float)
    op_device = defaultdict(float)
    by_name = defaultdict(float)
    for (s, e, name, corr), (cs, ce) in zip(inside, clipped):
        dur = ce - cs
        by_name[name] += dur
        launch = runtime.get(corr)
        if launch is None:
            span_device['(unlaunched)'] += dur
            continue
        t, tid = launch
        sp = spans.innermost(t)
        span_device[sp[2][len(PREFIX):] if sp else '(none)'] += dur
        ranges = op_ranges.get(tid)
        op = ranges.innermost(t) if ranges else None
        if op is not None:
            op_device[op[2]] += dur

    span_host = defaultdict(float)
    span_count = defaultdict(int)
    for s, e, name in spans.ranges:
        span_host[name[len(PREFIX):]] += e - s
        span_count[name[len(PREFIX):]] += 1

    busy = merged(clipped)
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gap_by_label = defaultdict(float)
    for s, e in gaps:
        sp = spans.innermost(s)
        op = main_ops.innermost(s)
        label = (sp[2][len(PREFIX):] if sp else '(none)') + ' | ' + \
            (op[2] if op else '(python)')
        gap_by_label[label] += e - s
    top = lambda d: [[k, v] for k, v in sorted(            # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(attributed_window_s=w1 - w0,
                attributed_busy_s=sum(e - s for s, e in busy),
                span_device_s=dict(span_device), span_host_s=dict(span_host),
                span_count=dict(span_count), op_device_s=dict(op_device),
                op_calls={k: v for k, v in op_calls.items()},
                breakdown=dict(device_ops=top(by_name),
                               idle_gaps=top(gap_by_label)))
