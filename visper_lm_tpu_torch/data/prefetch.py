"""Background batch prefetching on the host (counterpart of
visper_lm_tpu/data/prefetch.py).

`PrefetchIterator(it, depth)`: a producer thread drains `it` into a queue of
`depth` items, so host-side batch assembly (image decode, the native resize,
the teachers' pixels) overlaps the device step. The pixel loops run in numpy
and ctypes code that releases the GIL, so a thread is enough. An exception
raised by the producer surfaces at the consumer's `next()`, with its
traceback; after it (or at the end) the iterator is exhausted. `close()`
stops the producer.

This is the host half of the input pipeline. The trainer's `_Prefetcher`
(train/trainer.py) is the device half: it copies finished batches to the
card on a side stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

_DONE = object()


class _Raised:
    def __init__(self, error: BaseException):
        self.error = error


class PrefetchIterator:
    """Iterate `src` on a background thread, keeping up to `depth` items ready."""

    def __init__(self, src: Iterable[Any], depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._src = iter(src)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, item: Any) -> bool:
        # bounded put that stays responsive to close()
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self) -> None:
        try:
            for item in self._src:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - handed to the consumer
            self._put(_Raised(e))
            return
        self._put(_DONE)

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _DONE:
            self._stop.set()
            raise StopIteration
        if isinstance(item, _Raised):
            self._stop.set()
            raise item.error
        return item

    def close(self) -> None:
        self._stop.set()
        try:                        # unblock a producer waiting on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
