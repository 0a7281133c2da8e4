"""Threaded batch prefetch (counterpart of ThreadedLoader in
mdd_tpu/data/prefetch.py; its host-sharding helpers wait for the port's
scale-out slice).

A producer thread runs the underlying loader and keeps a bounded queue of
ready batches ahead of the training step, so ark reads, augmentation and
padding on the host overlap the device's work.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List

_SENTINEL = object()


class ThreadedLoader:
    """Wrap any batch iterable with a producer thread + bounded queue.

    Each __iter__ starts a fresh producer (so epochs work naturally).
    Exceptions in the producer propagate to the consumer.
    """

    def __init__(self, loader: Iterable, prefetch: int = 4):
        self.loader = loader
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.loader)  # type: ignore[arg-type]

    @property
    def batch_size(self):
        return getattr(self.loader, "batch_size", None)

    def set_epoch(self, epoch: int) -> None:
        """Delegate epoch fast-forwarding (checkpoint resume) to the
        wrapped loader."""
        inner = getattr(self.loader, "set_epoch", None)
        if inner is not None:
            inner(epoch)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        err: List[BaseException] = []
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that gives up when the consumer is gone —
            an abandoned iterator (consumer raised / was GC'd) must not
            leave the producer blocked forever holding batch references."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for batch in self.loader:
                    if not _put(batch):
                        return
            except BaseException as e:  # noqa: BLE001 — propagate to consumer
                err.append(e)
            finally:
                _put(_SENTINEL)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()   # normal exit, consumer exception, or GeneratorExit
