"""The program pass: the port's own spans and counters over a pass that the
profiler slows as little as the timing pass.

The port marks its layers from inside (``boxinstseg_tpu_torch.utils.
profiling``: ``span``, ``count``, ``record``). Its recorder stamps each span
with ``time.time_ns()``, the Unix-epoch clock on which the profiler stamps
its events, so a pass that records the device's activity alone
(``trace.device_profiler``: no host ops, no shapes) can still be read by
the spans open on the harness's thread:

- each device activity goes to the innermost program span open on the
  recording thread when its runtime call launched it (found by the
  correlation id, as ``trace.read_trace`` does; the backward's launches,
  made by the autograd thread while the recording thread waits inside
  ``backward``, go to ``backward``);
- each idle gap of the window goes to the innermost program span open on
  the recording thread when the gap began;
- counters (hand-kernel launches, ``host_sync``) are the recorder's, over
  the pass.

The profiler's device stamps may lead its own host stamps (the runtime
calls, which agree with the recorder's): on the card some activities are
stamped up to milliseconds before the call that launched them. An
activity never begins before its launch, so the pass's activities are read
moved later by the largest such lead (``launch_check``), which aligns the
gaps with the spans; the lead and the activities stamped before their
launch are reported.

``program_pass`` runs the pass; ``read`` turns its profiler run and
recorder into the records under ``rec['program']`` that the readers in
``perfbench/metrics`` take (times in seconds, counts over the pass;
``steps`` divides them). Without a card there is no device trace, and
only the counters are kept.
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from . import trace

# the runtime calls that block the host until the device catches up
BLOCKING = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
            'cudaEventSynchronize', 'cudaMemcpy', 'cudaMemcpy2D')
NO_SPAN = '(none)'


def program_pass(one: Callable[[int], object], first: int, n: int,
                 is_cuda: bool, finish: Callable[[], None]) -> Dict:
    """``one(first) ... one(first + n - 1)`` under the timing pass's
    device-only profiler and the port's recorder with its host syncs;
    ``finish`` waits for the device inside both. Returns ``read``'s
    records."""
    from boxinstseg_tpu_torch.utils.profiling import record
    prof = trace.device_profiler(is_cuda)
    with prof, record(syncs=True) as rec:
        w0 = time.time_ns()
        for k in range(first, first + n):
            one(k)
        finish()
        w1 = time.time_ns()
    return read(events_of(prof), rec, w0, w1, n)


def events_of(prof) -> Optional[Dict]:
    """The device activities (start ns, end ns, name, correlation id), the
    CUDA API calls (``cuda*``, ``cu*``) by correlation id (a list of
    (start ns, name)) and the count of each host event's name, of a
    profiler run; None without one. An activity's launch is the first
    call of its id.
    (In a pass that records the device's activity alone no call is linked
    to a host op, so ``trace.read_trace``'s test for a launch finds none
    there.)"""
    if not hasattr(prof, 'profiler') or prof.profiler is None:
        return None
    from torch.autograd import DeviceType
    device, launch, calls = [], defaultdict(list), defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.name().startswith(trace.PREFIX):
                continue
            device.append((e.start_ns(), e.end_ns(), e.name(),
                           e.correlation_id()))
        else:
            calls[e.name()] += 1
            if e.correlation_id() > 0 and e.name().startswith('cu'):
                launch[e.correlation_id()].append((e.start_ns(), e.name()))
    return dict(device=device, launch=dict(launch), calls=dict(calls))


def launch_check(events: Dict, w0: int, w1: int) -> Dict:
    """How the window's activities meet their launches in the profiler's
    own stamps: ``shared_ids`` (correlation ids of more than one call, by
    their calls' names), ``before_launch`` (activities stamped before the
    first call of their id), ``before_sample`` (the five earliest: ns
    before the call, the activity, the call) and ``lead_ns``, the largest
    such lead (0 without one)."""
    shared = defaultdict(int)
    for calls in events['launch'].values():
        if len(calls) > 1:
            shared[' + '.join(sorted(c[1] for c in calls))] += 1
    before = []
    for start, end, name, corr in events['device']:
        calls = events['launch'].get(corr)
        if end > w0 and start < w1 and calls and start < min(calls)[0]:
            before.append((min(calls)[0] - start, name[:48], min(calls)[1]))
    before.sort()
    return dict(shared_ids=dict(shared), before_launch=len(before),
                before_sample=[list(b) for b in before[-5:]],
                lead_ns=before[-1][0] if before else 0)


def _is_kernel(name: str) -> bool:
    return not name.startswith(('Memcpy', 'Memset'))


def read(events: Optional[Dict], rec, w0: int, w1: int, steps: int
         ) -> Dict:
    """The records of one program pass (see the module docstring):
    ``steps``; the recorder's ``counts``, ``sync_sites`` and
    ``syncs_watched``; with a device trace, ``window_s``, ``busy_s``,
    ``device_s`` / ``idle_s`` by innermost span and ``device_under_s`` /
    ``idle_under_s`` by every span open (a span's own and its
    descendants'), ``kernels`` (kernel launches), ``early_kernels``
    (activities stamped before the span their launch fell in began: 0
    when the profiler's device and host stamps agree) with
    ``early_sample`` (the five earliest: ns before the span, the activity,
    its call, the span),
    ``unlaunched`` (activities with no launch in the trace), the fields of
    ``launch_check`` (the busy intervals and the gaps are read with the
    activities moved later by its ``lead_ns``),
    ``blocking_calls`` (the blocking runtime calls by name) and
    ``idle_gaps`` (the ten largest idle totals by span path)."""
    out = dict(steps=steps, counts=dict(rec.counts),
               sync_sites=dict(rec.sync_sites),
               syncs_watched=bool(rec.syncs_watched))
    if not events:
        return out
    spans = rec.spans
    mine = [i for i, s in enumerate(spans)
            if s.thread == rec.thread and s.end_ns]
    ranges = trace._Ranges([(spans[i].begin_ns, spans[i].end_ns, i)
                            for i in mine])

    def chain(index: Optional[int]) -> List[str]:
        names = []
        while index is not None and index >= 0:
            names.append(spans[index].name)
            index = spans[index].parent
        return names or [NO_SPAN]

    def innermost(t: int) -> Optional[int]:
        r = ranges.innermost(t)
        return r[2] if r else None

    check = launch_check(events, w0, w1)
    # an activity never begins before its launch: where the profiler's
    # device stamps lead its host stamps, every activity is moved later by
    # the largest lead, so that its gaps meet the spans open at the time
    lead = check['lead_ns']
    device_s, device_under = defaultdict(float), defaultdict(float)
    kernels = unlaunched = 0
    early = []
    inside = [(s + lead, e + lead, name, corr)
              for s, e, name, corr in events['device']
              if e + lead > w0 and s + lead < w1]
    for start, end, name, corr in inside:
        dur = (min(end, w1) - max(start, w0)) * 1e-9
        kernels += _is_kernel(name)
        calls = events['launch'].get(corr)
        call = min(calls) if calls else None
        if call is None:
            unlaunched += 1
            device_s['(unlaunched)'] += dur
            continue
        index = innermost(call[0])
        if index is not None and start - lead < spans[index].begin_ns:
            early.append((spans[index].begin_ns - start + lead, name[:48],
                          call[1], spans[index].name))
        names = chain(index)
        device_s[names[0]] += dur
        for n in set(names):
            device_under[n] += dur
    busy = trace.merged([(max(s, w0), min(e, w1))
                         for s, e, _, _ in inside])
    idle_s, idle_under, by_path = (defaultdict(float), defaultdict(float),
                                   defaultdict(float))
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            names = chain(innermost(prev))
            gap = (s - prev) * 1e-9
            idle_s[names[0]] += gap
            for n in set(names):
                idle_under[n] += gap
            by_path['/'.join(reversed(names))] += gap
        prev = max(prev, e)
    calls = events['calls']
    out.update(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        device_s=dict(device_s), device_under_s=dict(device_under),
        idle_s=dict(idle_s), idle_under_s=dict(idle_under),
        kernels=kernels, early_kernels=len(early),
        early_sample=[list(e) for e in sorted(early)[-5:]],
        unlaunched=unlaunched, **check,
        blocking_calls={k: calls[k] for k in BLOCKING if k in calls},
        idle_gaps=[[k, v] for k, v in sorted(
            by_path.items(), key=lambda kv: -kv[1])[:10]])
    return out


def report(program: Dict, file=sys.stderr) -> None:
    """The program pass's top idle gaps by span path, its counts and the
    clock check, as lines of standard error."""
    n = max(program['steps'], 1)
    if 'idle_gaps' in program:
        print('program pass idle gaps (s): ' + ', '.join(
            f'{k} {v:.4f}' for k, v in program['idle_gaps']), file=file)
        print(f'program pass: {program["kernels"] / n:g} kernels a step, '
              f'{program["early_kernels"]} activities before their span '
              f'{program["early_sample"]}, {program["before_launch"]} '
              f'before their launch {program["before_sample"]}, '
              f'{program["unlaunched"]} with no launch, device stamps '
              f'moved {program["lead_ns"]} ns later, ids of several calls '
              f'{program["shared_ids"]}, blocking runtime calls '
              f'{program["blocking_calls"]}', file=file)
    print(f'program pass counts a step: '
          f'{ {k: v / n for k, v in sorted(program["counts"].items())} }; '
          f'host syncs by site: {program["sync_sites"]}', file=file)
