"""Host->device pipelining for the training loop.

PyTorch enqueues card work asynchronously, so the host stalls only when it
reads a value back. `prefetch_to_device` walks the loader in a daemon
thread, applies the caller's device-put (pinned memory and a non-blocking
copy, `training/infer_driver.device_batch`) `size` batches ahead, and hands
back device-resident batches: the upload of batch N+1 overlaps batch N's
step. The trainer reads a loss only every log_frequency steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

_END = object()


def prefetch_to_device(batches: Iterable, put: Optional[Callable] = None,
                       size: int = 2) -> Iterator:
    """Yield `put(batch)` for each batch, staying up to `size` items ahead.

    `put` (default: identity) runs in the prefetch thread — pass the
    device-put/shard function so uploads are enqueued before the consumer
    needs them. Exceptions in the producer re-raise at the consumer.
    """
    if put is None:
        put = lambda x: x
    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))

    def producer():
        try:
            for b in batches:
                q.put(put(b))
        except BaseException as e:  # surface loader errors to the consumer
            q.put(e)
            return
        q.put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
