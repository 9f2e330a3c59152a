"""Threaded prefetching batch loader (counterpart of ``videoframeinterpolation_tpu/data/loader.py``).

Worker threads read items while the caller is busy with the previous
batch; batches are emitted in index order. Each host process sees a
disjoint, per-epoch-shuffled shard of the index space, as
``DistributedSampler`` gives it. With ``shuffle=False`` the batches are
``0..B-1``, ``B..2B-1``, ... of the shard, as the JAX loader gives them.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Per-epoch reshuffle (DistributedSampler.set_epoch semantics)."""
        self._epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.Generator(np.random.PCG64(self.seed + self._epoch))
            rng.shuffle(idx)
        if self.num_shards > 1:
            # Pad so every shard sees the same number of items, then slice.
            total = ((n + self.num_shards - 1) // self.num_shards) * self.num_shards
            if total > n:
                idx = np.concatenate([idx, idx[: total - n]])
            idx = idx[self.shard_index::self.num_shards]
        return idx

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        indices = self._epoch_indices()
        nb = len(self)
        if nb == 0:
            return
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)]
        item_q: queue.Queue = queue.Queue()
        for bi, batch_idx in enumerate(batches):
            for pos, di in enumerate(batch_idx):
                item_q.put((bi, pos, int(di)))
        slots = [[None] * len(b) for b in batches]
        missing = [len(b) for b in batches]
        lock = threading.Lock()
        done = threading.Event()
        # Finished batches as (batch index, batch); the consumer reorders.
        ready: queue.Queue = queue.Queue(maxsize=self.prefetch)

        def put(entry) -> None:
            while not done.is_set():
                try:
                    ready.put(entry, timeout=0.2)
                    return
                except queue.Full:
                    continue

        def worker():
            while not done.is_set():
                try:
                    bi, pos, di = item_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = self.dataset[di]
                except Exception as e:   # re-raised by the consumer
                    put((bi, e))
                    return
                with lock:
                    slots[bi][pos] = item
                    missing[bi] -= 1
                    finished = missing[bi] == 0
                if finished:
                    batch = _collate(slots[bi])
                    slots[bi] = None
                    put((bi, batch))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        pending: dict[int, dict] = {}
        try:
            for want in range(nb):
                while want not in pending:
                    bi, batch = ready.get()
                    if isinstance(batch, Exception):
                        raise batch
                    pending[bi] = batch
                yield pending.pop(want)
        finally:
            done.set()


def _collate(items: list[dict]) -> dict:
    keys = items[0].keys()
    return {k: np.stack([it[k] for it in items], axis=0) for k in keys}
