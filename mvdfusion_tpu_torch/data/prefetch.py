"""Background scene prefetching (a copy of mvdfusion_tpu/data/prefetch.py).

The reference overlaps host data loading with GPU compute via torch
DataLoader workers (train.py:48-53, num_workers=4). Here a single background
thread decodes scenes ahead of the training loop through a bounded queue —
host decode overlaps device steps without multiprocessing.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator


class PrefetchIterator:
    """Wrap an index iterable + fetch function with lookahead prefetch.

    Supports early exit: `close()` (called automatically when the consumer
    abandons iteration, and usable as a context manager) unblocks and joins
    the producer thread so an interrupted epoch (--max-steps, exception)
    doesn't leave a thread parked on a full queue holding a decoded batch.
    """

    def __init__(self, indices: Iterable, fetch: Callable, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._indices = list(indices)
        self._fetch = fetch
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """put that gives up when close() is requested; True if enqueued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for idx in self._indices:
                if self._stop.is_set():
                    return
                if not self._put(("ok", self._fetch(idx))):
                    return
        except Exception as e:  # surface in consumer thread
            self._put(("err", e))
            return
        self._put(("done", None))

    def close(self) -> None:
        """Stop the producer and join it (idempotent)."""
        self._stop.set()
        # drain so a producer blocked inside q.put's timeout loop exits fast
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> Iterator:
        try:
            while True:
                kind, item = self._q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise item
                yield item
        finally:
            # consumer finished or bailed early (break/return/exception):
            # tear the producer down either way
            self.close()

    def __len__(self):
        return len(self._indices)
