"""Host-side batching + prefetch.

Replaces the reference's torch DataLoader(num_workers=4) with a thread-pool
prefetcher: samples are assembled in worker threads (PIL decode + numpy ops
release the GIL for the heavy parts), stacked, and queued so the accelerator
never waits on the host. Keys with per-frame variable shapes ("depth_gt")
are collated as lists, everything else as stacked numpy arrays.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np

_UNSTACKED_KEYS = {"depth_gt", "path"}


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, object]:
    batch: Dict[str, object] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key in _UNSTACKED_KEYS:
            batch[key] = vals
        else:
            batch[key] = np.stack(vals)
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 2,
                 prefetch: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(idx)
        out = [idx[i: i + self.batch_size]
               for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            out = [b for b in out if len(b) == self.batch_size]
        return out

    def __iter__(self) -> Iterator[Dict[str, object]]:
        batches = self._batches()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def safe_put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            """Fan sample assembly out over `num_workers` threads (PIL
            decode / numpy resize / velodyne projection release the GIL),
            collate in submission order. Mirrors the reference's
            DataLoader(num_workers=4) workers (reference trainer.py:158-160)
            with threads instead of processes."""
            try:
                if self.num_workers <= 1:
                    for b in batches:
                        if stop.is_set():
                            return
                        if not safe_put(collate([self.dataset[i]
                                                 for i in b])):
                            return
                    return
                from collections import deque
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(self.num_workers) as ex:
                    pending: deque = deque()
                    it = iter(batches)

                    def submit_next() -> bool:
                        b = next(it, None)
                        if b is None:
                            return False
                        pending.append(
                            [ex.submit(self.dataset.__getitem__, i)
                             for i in b])
                        return True

                    # keep prefetch+1 batches of samples in flight
                    for _ in range(self.prefetch + 1):
                        if not submit_next():
                            break
                    while pending and not stop.is_set():
                        futs = pending.popleft()
                        samples = [f.result() for f in futs]
                        if not safe_put(collate(samples)):
                            return
                        submit_next()
            except Exception as e:  # surface worker errors to the consumer
                safe_put(e)
            finally:
                safe_put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
