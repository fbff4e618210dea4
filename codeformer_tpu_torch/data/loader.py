"""Batched, prefetching data loader (the port's own copy of
codeformer_tpu/data/loader.py, host-side numpy).

The counterpart of the reference's DataLoader + EnlargedSampler
(basicsr/data/{data_sampler.py, prefetch_dataloader.py}): rank-strided
index sampling, a thread pool for the cv2-heavy degradation synthesis,
and a lookahead queue so host compute overlaps device steps. Batches are
stacked NHWC numpy; the trainer moves them to its device. A CUDA-stream
prefetcher (the JAX copy's DevicePrefetcher) is not ported yet.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np


class EnlargedSampler:
    """Epoch-seeded shuffled indices with `ratio` virtual enlargement and
    process-strided sharding (data_sampler.py:21-48)."""

    def __init__(self, num_samples: int, num_replicas: int = 1,
                 rank: int = 0, ratio: int = 1):
        self.num_samples_raw = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.total_size = ((num_samples * ratio + num_replicas - 1)
                           // num_replicas) * num_replicas
        self.per_rank = self.total_size // num_replicas
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        g = np.random.default_rng(self.epoch)
        indices = g.permutation(self.total_size)
        indices = indices[self.rank:self.total_size:self.num_replicas]
        for idx in indices:
            yield int(idx % self.num_samples_raw)

    def __len__(self):
        return self.per_rank


def _stack(samples) -> Dict:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals  # e.g. gt_path strings
    return out


class DataLoader:
    """Iterates batches forever (training) or one epoch (validation),
    starting at the sampler's epoch `start_epoch` (a resumed run's
    epoch, as the reference's loop sets it; basicsr/train.py:171-210)."""

    def __init__(self, dataset, batch_size: int, sampler=None,
                 num_workers: int = 4, prefetch: int = 4,
                 drop_last: bool = True, loop: bool = True,
                 start_epoch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or EnlargedSampler(len(dataset))
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.loop = loop
        self.start_epoch = start_epoch

    def __iter__(self):
        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def epoch_batches(epoch: int):
            self.sampler.set_epoch(epoch)
            batch_idx = []
            for idx in self.sampler:
                batch_idx.append(idx)
                if len(batch_idx) == self.batch_size:
                    yield batch_idx
                    batch_idx = []
            if batch_idx and not self.drop_last:
                yield batch_idx

        def put(item) -> bool:
            # never block forever: an abandoned consumer sets `stop`
            # without draining, and the produce thread must still reach
            # its shutdown
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # Backpressure-bounded pipeline: at most `prefetch + 1`
            # batches are in flight in the pool at any time. Submitting
            # the whole epoch up front (the obvious pool.map over the
            # sampler) is wrong twice over: the pool races arbitrarily
            # far ahead of the consumer (completed-but-unconsumed
            # results grow without bound — an epoch is
            # len(dataset) * enlarge_ratio images), and the leftover
            # queued work keeps the worker threads alive at interpreter
            # exit (concurrent.futures joins them), stalling shutdown by
            # however much of the epoch was still queued.
            pool = ThreadPoolExecutor(self.num_workers)
            from collections import deque
            inflight: 'deque' = deque()
            max_inflight = self.prefetch + 1

            def drain_one() -> bool:
                futs = inflight.popleft()
                try:
                    batch = _stack([f.result() for f in futs])
                except BaseException as e:  # propagate to the consumer
                    return not put(e)
                return not put(batch)

            epoch = self.start_epoch
            try:
                while not stop.is_set():
                    for bidx in epoch_batches(epoch):
                        inflight.append([
                            pool.submit(self.dataset.__getitem__, i)
                            for i in bidx])
                        if len(inflight) >= max_inflight:
                            if drain_one():
                                return
                    while inflight:
                        if drain_one():
                            return
                    if not self.loop:
                        break
                    epoch += 1
            finally:
                put(None)
                pool.shutdown(wait=False, cancel_futures=True)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)


def build_dataloader(dataset, dataset_opt: Dict, sampler=None,
                     num_replicas: int = 1, rank: int = 0,
                     is_train: bool = True,
                     start_epoch: int = 0) -> DataLoader:
    """Factory mirroring basicsr/data/__init__.py:40-93; a training
    loader starts at `start_epoch`."""
    if is_train:
        batch = dataset_opt['batch_size_per_gpu']
        sampler = sampler or EnlargedSampler(
            len(dataset), num_replicas, rank,
            dataset_opt.get('dataset_enlarge_ratio', 1))
        return DataLoader(dataset, batch,
                          sampler=sampler,
                          num_workers=dataset_opt.get(
                              'num_worker_per_gpu', 4),
                          prefetch=dataset_opt.get('num_prefetch_queue', 4),
                          drop_last=True, loop=True, start_epoch=start_epoch)
    return DataLoader(dataset, 1, sampler=EnlargedSampler(len(dataset)),
                      num_workers=1, prefetch=2, drop_last=False,
                      loop=False)
