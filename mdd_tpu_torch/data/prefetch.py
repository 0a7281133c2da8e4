"""Threaded batch prefetch and host sharding (counterpart of
mdd_tpu/data/prefetch.py).

  * ThreadedLoader: a producer thread runs the underlying loader and keeps
    a bounded queue of ready batches ahead of the training step, so ark
    reads, augmentation and padding on the host overlap the device's work;
  * shard_for_host(_primary): the deterministic equal-length share of an
    utterance list that each rank of a multi-process evaluation decodes,
    with the wrap-around duplicates flagged so each utterance is scored
    once.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List, Sequence, Tuple, TypeVar

T = TypeVar("T")

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

    @property
    def shape_coordinated(self):
        return getattr(self.loader, "shape_coordinated", False)

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


def shard_for_host(items: Sequence[T], process_index: int,
                   process_count: int) -> List[T]:
    """Rank `process_index`'s share: ceil(N / process_count) items, the
    tail wrapping around to the start so every rank runs as many
    batches."""
    return shard_for_host_primary(items, process_index, process_count)[0]


def shard_for_host_primary(items: Sequence[T], process_index: int,
                           process_count: int
                           ) -> Tuple[List[T], List[bool]]:
    """shard_for_host plus a scoring-primary flag an item.  Rank p's
    position i is global slot s = p * ceil(N / P) + i and holds
    items[s % N]; it is the primary iff s < N (the item's first
    occurrence), so the wrapped duplicates are decoded but not scored."""
    if process_count <= 1:
        return list(items), [True] * len(items)
    n = len(items)
    per_host = -(-n // process_count)
    start = process_index * per_host
    out = [items[(start + i) % n] for i in range(per_host)]
    primary = [start + i < n for i in range(per_host)]
    return out, primary
