"""Host prefetch: produce items on a background thread, a bounded queue
ahead of the consumer.

The counterpart of ``repro/data/pipeline.py`` (its ``prefetch_iter``; the
LM's ``TokenPipeline`` comes with the training slice).  The out-of-core loops
(``BlazeSession.map_reduce`` over a chunked source, ``Program.run_stream``)
decode block k+1 here while block k runs.  A ``produce`` that touches CUDA
(pinned buffers, copies on a stream) must set its device itself: a new
thread starts on device 0.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

_DONE = object()
_PREFETCH_THREAD_NAME = "blaze-prefetch"


class _PrefetchFailure:
    """Error sentinel: carries a worker's exception across the queue."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_iter(produce: Callable, items: Iterable, depth: int = 2) -> Iterator[tuple]:
    """Yield ``(item, produce(item))`` in order, a worker thread keeping up
    to ``depth`` results queued while the consumer works on the current one.

    If ``produce`` raises, the exception is re-raised at the consumer's next
    pull (the worker never dies leaving the consumer blocked on an empty
    queue); if the consumer abandons the iterator (``break``, ``close()``,
    garbage collection), a stop event unblocks the worker's bounded ``put``
    so that it exits instead of blocking on a full queue.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def _put(x) -> bool:
        # A bounded put that gives up once the consumer has gone away.
        while not stop.is_set():
            try:
                q.put(x, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for it in items:
                if stop.is_set():
                    return
                if not _put((it, produce(it))):
                    return
            _put(_DONE)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer, raised there
            _put(_PrefetchFailure(e))

    t = threading.Thread(target=worker, daemon=True, name=_PREFETCH_THREAD_NAME)
    t.start()
    try:
        while True:
            got = q.get()
            if got is _DONE:
                return
            if isinstance(got, _PrefetchFailure):
                raise got.exc
            yield got
    finally:
        stop.set()
        t.join(timeout=10.0)
