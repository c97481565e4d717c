"""Threaded prefetching data loader.

Replaces the reference's torch DataLoader worker processes
(reference: mmdet/datasets/builder.py:87-139). cv2/numpy release the GIL
for the heavy work, so a thread pool + a small prefetch queue keeps the
TPU fed while the step runs; batches are plain numpy dicts handed to
``parallel.shard_batch``.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from .batcher import GroupedBatchSampler, SequentialBatchSampler, \
    StaticBatcher


class _ProducerError:
    """An exception raised in ``TrainLoader``'s producer thread, carried
    through the prefetch queue to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class TrainLoader:
    """``batch_size`` is the GLOBAL batch. In multi-process runs every
    process samples the same global index sequence (same seed) and loads
    only its contiguous slice — the analog of the reference's
    DistributedGroupSampler per-rank shards (mmdet/datasets/
    builder.py:140-182)."""

    def __init__(self, dataset, batch_size: int, batcher: StaticBatcher,
                 num_workers: int = 8, seed: int = 0, prefetch: int = 2,
                 process_id: int = 0, process_count: int = 1,
                 batch_scales=None):
        assert batch_size % process_count == 0, (batch_size, process_count)
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_slice = slice(
            process_id * (batch_size // process_count),
            (process_id + 1) * (batch_size // process_count))
        self.batcher = batcher
        self.sampler = GroupedBatchSampler(dataset.flag, batch_size,
                                           seed=seed)
        # workers_per_gpu=0 means "load in-process" in the reference;
        # threads are cheap here, so it just becomes one worker thread
        self.pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
        self.prefetch = prefetch
        self.seed = seed
        # multiscale-'value' choice sampled PER BATCH so the whole
        # batch fits one short-side canvas bucket (per-image choices
        # keep the same marginal distribution but every mixed batch
        # pads up to the largest canvas). Seeded on (seed, step): every
        # process picks the same scale for the same global batch.
        self.batch_scales = [tuple(s) for s in batch_scales] \
            if batch_scales else None

    def _load_one(self, idx: int, epoch_seed: int, scale=None):
        rng = np.random.RandomState((epoch_seed * 1000003 + idx) % 2**31)
        out = self.dataset.prepare(idx, rng, scale=scale)
        tries = 0
        while out is None and tries < 10:   # e.g. RandomCrop rejected
            tries += 1
            alt = rng.randint(len(self.dataset))
            out = self.dataset.prepare(alt, rng, scale=scale)
        if out is None:
            raise RuntimeError(f'could not load a valid sample near {idx}')
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            step = 0
            for batch_idx in self.sampler:
                if stop.is_set():
                    return
                batch_idx = batch_idx[self.local_slice]
                scale = None
                if self.batch_scales:
                    brng = np.random.RandomState(
                        (self.seed * 7919 + step) % 2**31)
                    scale = self.batch_scales[
                        brng.randint(len(self.batch_scales))]
                futs = [self.pool.submit(self._load_one, i,
                                         self.seed + step, scale)
                        for i in batch_idx]
                samples = [f.result() for f in futs]
                q.put(self.batcher(samples))
                step += 1

        def producer():
            # an error in loading or batching ends the thread; it goes on
            # the queue so that the consumer raises it instead of waiting
            try:
                produce()
            except Exception as exc:
                q.put(_ProducerError(exc))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item
        finally:
            stop.set()


class EvalLoader:
    def __init__(self, dataset, batch_size: int, batcher: StaticBatcher,
                 num_workers: int = 8, indices=None):
        """``indices``: optional dataset-index subset (multi-process eval
        shards the dataset across processes, reference multi_gpu_test's
        per-rank DistributedSampler slice, apis/test.py:81-130)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.batcher = batcher
        self.indices = list(range(len(dataset))) if indices is None \
            else list(indices)
        # workers_per_gpu=0 means "load in-process" in the reference;
        # threads are cheap here, so it just becomes one worker thread
        self.pool = ThreadPoolExecutor(max_workers=max(1, num_workers))

    def __len__(self):
        return (len(self.indices) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        """Yields (batch, real_count, sample_metas)."""
        sampler = SequentialBatchSampler(len(self.indices), self.batch_size)
        for pos, real in sampler:
            idx = [self.indices[p] for p in pos]
            futs = [self.pool.submit(self.dataset.prepare, i) for i in idx]
            samples = [f.result() for f in futs]
            metas = [dict(img_shape=s['img_shape'],
                          ori_shape=s['ori_shape'],
                          scale_factor=s.get('scale_factor'))
                     for s in samples]
            yield self.batcher(samples), real, metas
