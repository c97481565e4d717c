"""Profiling helpers, counterpart of ``boxinstseg_tpu/utils/profiling.py``
(reference: mmdet/utils/profiling.py profile_time with CUDA events, and
MemoryProfilerHook): a host clock around a block that ends in a device
sync, a ``torch.profiler`` trace, each card's memory statistics, and the
port's own spans and counters.

Spans and counters (``span``, ``count``, ``record``) mark the port's layers
from inside: the train step's copy, forwards, loss phases, backward,
gradient norm and optimizer, predict and format, the detector's build and
the kernels' build. A span costs one flag read while nothing listens.
Under a ``torch.profiler`` run it is a ``record_function`` range named
``bis:<name>``; inside ``record()`` it is also kept in memory with its
parent, its thread and its host times from ``time.time_ns()``, the clock
on which the profiler stamps its events, so that a trace that records the
device's activity alone can be read by the spans open on the host.
``count`` adds to a process-wide table (``COUNTS``), and inside
``record()`` to the innermost span open on the recording thread too.
"""
from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = 'bis:'
# what count() has counted in this process, by name (kernel.<op> for each
# hand-kernel launch, native_build for each nvcc process, host_sync)
COUNTS: collections.Counter = collections.Counter()
_NULL = contextlib.nullcontext()
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SYNC_MESSAGE = 'synchronizing CUDA operation'
_recorder: Optional['Recorder'] = None


class SpanRecord:
    """One span of a ``Recorder``: its name, the index of its parent span
    (-1 for a root) and of its root (the identifier that the spans of one
    step or image share), the thread that opened it, its host times in
    Unix-epoch ns (``end_ns`` 0 while it is open) and the counts added
    while it was the innermost open span."""
    __slots__ = ('name', 'parent', 'root', 'thread', 'begin_ns', 'end_ns',
                 'counts')

    def __init__(self, name, parent, root, thread, begin_ns):
        self.name, self.parent, self.root = name, parent, root
        self.thread, self.begin_ns, self.end_ns = thread, begin_ns, 0
        self.counts: Dict[str, int] = {}


class Recorder:
    """What ``record()`` keeps: ``spans`` in the order they opened,
    ``counts`` (every count while it was on), ``sync_sites`` (host syncs by
    the first frame of the port that made them, ``file:line``), ``thread``
    (the recording thread, whose spans counts from other threads go
    under) and ``syncs_watched`` (whether host syncs were counted)."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.counts: collections.Counter = collections.Counter()
        self.sync_sites: collections.Counter = collections.Counter()
        self.thread = threading.get_ident()
        self.syncs_watched = False
        self._open: Dict[int, List[int]] = {}

    def _enter(self, name: str) -> int:
        tid = threading.get_ident()
        stack = self._open.setdefault(tid, [])
        parent = stack[-1] if stack else -1
        index = len(self.spans)
        root = self.spans[parent].root if stack else index
        self.spans.append(SpanRecord(name, parent, root, tid,
                                     time.time_ns()))
        stack.append(index)
        return index

    def _exit(self, index: int) -> None:
        rec = self.spans[index]
        rec.end_ns = time.time_ns()
        self._open[rec.thread].pop()

    def _count(self, name: str, n: int) -> None:
        self.counts[name] += n
        stack = self._open.get(threading.get_ident()) or \
            self._open.get(self.thread)
        if stack:
            counts = self.spans[stack[-1]].counts
            counts[name] = counts.get(name, 0) + n

    def self_ns(self) -> Dict[str, int]:
        """Each span name's host time less its children's, summed over
        the closed spans, in ns."""
        out: Dict[str, int] = collections.defaultdict(int)
        for rec in self.spans:
            if rec.end_ns:
                out[rec.name] += rec.end_ns - rec.begin_ns
                if rec.parent >= 0:
                    out[self.spans[rec.parent].name] -= \
                        rec.end_ns - rec.begin_ns
        return dict(out)

    def total_ns(self, name: str) -> int:
        """The summed host time of the closed spans named ``name``."""
        return sum(r.end_ns - r.begin_ns for r in self.spans
                   if r.name == name and r.end_ns)


class _Span:
    __slots__ = ('name', 'rf', 'rec', 'index')

    def __init__(self, name: str):
        self.name = name
        self.rf = None
        self.rec = None

    def __enter__(self):
        rec = _recorder
        if rec is not None:
            # the recorder's stamps enclose the profiler's
            self.rec, self.index = rec, rec._enter(self.name)
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.rec is not None:
            self.rec._exit(self.index)
        return False


def span(name: str):
    """A context manager around one layer's work, named ``name``; a shared
    no-op while no profiler runs and no ``record()`` is open."""
    if _recorder is None and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTS[name]`` and, inside ``record()``, under the
    innermost span open on this thread (or else on the recording
    thread)."""
    COUNTS[name] += n
    rec = _recorder
    if rec is not None:
        rec._count(name, n)


def _sync_site() -> str:
    """``file:line`` of the innermost frame of the port, this module
    left out, in the current stack; '(outside)' without one."""
    frame = sys._getframe(2)
    here = os.path.abspath(__file__)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(_PKG) and path != here:
            return f'{os.path.relpath(path, os.path.dirname(_PKG))}:' \
                f'{frame.f_lineno}'
        frame = frame.f_back
    return '(outside)'


@contextlib.contextmanager
def _watch_syncs(rec: Recorder):
    """Count each host sync that CUDA's sync debug mode warns of as
    ``host_sync`` (``count``) and by its call site; the previous mode and
    warning handling come back on exit. A no-op without a card."""
    if not torch.cuda.is_available():
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None,
                 line=None):
            if _SYNC_MESSAGE in str(message):
                rec.sync_sites[_sync_site()] += 1
                count('host_sync')
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.filterwarnings('always', message='.*' + _SYNC_MESSAGE)
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode('warn')
        rec.syncs_watched = True
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def record(syncs: bool = False):
    """Keep the spans and counts of the block in memory (see the module
    docstring); with ``syncs``, also count the host syncs (``_watch_syncs``).
    Yields the ``Recorder``; the recorder open before comes back on
    exit."""
    global _recorder
    rec, prev = Recorder(), _recorder
    _recorder = rec
    try:
        if syncs:
            with _watch_syncs(rec):
                yield rec
        else:
            yield rec
    finally:
        _recorder = prev


@contextlib.contextmanager
def profile_time(name: str, logger=None, sync: bool = True,
                 device='cuda'):
    """Wall-clock a block; with ``sync``, waits for the work queued on a
    CUDA ``device`` before the clock starts and before it stops, so that the
    time covers the device work launched inside. Logs (or prints) the
    milliseconds."""
    device = torch.device(device)
    do_sync = sync and device.type == 'cuda'
    if do_sync:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if do_sync:
        torch.cuda.synchronize(device)
    msg = f'{name}: {(time.perf_counter() - t0) * 1000:.2f} ms'
    if logger is not None:
        logger.info(msg)
    else:
        print(msg)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU activities, and CUDA
    ones where there is a card), written to ``log_dir/trace.json`` in the
    Chrome trace format (Perfetto, chrome://tracing) after a sync of the
    card, so that the block's last kernels are in it. Yields the file's
    path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, 'trace.json')
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def device_memory_stats() -> Dict[str, dict]:
    """``torch.cuda.memory_stats`` of each visible card, by ``cuda:{i}``,
    with ``bytes_in_use`` (``allocated_bytes.all.current``) added; empty
    without a card."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        stats = dict(torch.cuda.memory_stats(i))
        stats['bytes_in_use'] = stats.get('allocated_bytes.all.current', 0)
        out[f'cuda:{i}'] = stats
    return out

