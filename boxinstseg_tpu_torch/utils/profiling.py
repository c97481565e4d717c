"""Profiling helpers, counterpart of ``boxinstseg_tpu/utils/profiling.py``
(reference: mmdet/utils/profiling.py profile_time with CUDA events, and
MemoryProfilerHook): a host clock around a block that ends in a device
sync, a ``torch.profiler`` trace, and each card's memory statistics."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


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

