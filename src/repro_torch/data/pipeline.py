"""Data pipeline: host prefetch and a deterministic token stream.

The counterpart of ``repro/data/pipeline.py``.  ``prefetch_iter`` produces
items on a background thread, a bounded queue ahead of the consumer: the
out-of-core loops (``BlazeSession.map_reduce`` over a chunked source,
``Program.run_stream``) decode block k+1 there while block k runs.  A
``produce`` that touches CUDA (pinned buffers, copies on a stream) must set
its device itself: a new thread starts on device 0.  On a mesh of several
processes each rank runs its own worker over its own rows of each block, on
its own device; a read is no collective, so a read one rank retries leaves
the other ranks as they are.

``TokenPipeline`` is the LM's token stream: batch ``i`` is a pure function
of ``(seed, i)``, so a restarted host regenerates exactly the stream it
missed; its Zipf tokens match the word frequencies the paper's word count
stresses.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.core import faults

_DONE = object()
_PREFETCH_THREAD_NAME = "blaze-prefetch"
# A read is a pure function of its item, so the worker retries an injected
# read fault in place: the retried read is bit-equal.
_READ_RETRIES = 3


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

    Each read hits the ``prefetch.read`` fault point first; a
    ``TransientFault`` is retried in the worker (at most ``_READ_RETRIES``
    tries), and a fatal fault, or the last failed try, crosses the queue as
    any other worker exception does.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def _read(it):
        def once():
            faults.fault_point("prefetch.read")
            return produce(it)

        return faults.retry_in_place(once, tries=_READ_RETRIES)

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
                if not _put((it, _read(it))):
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


class TokenPipeline:
    """Batches of Zipf tokens for an LM (``cfg.vocab``): ``host_batch(step)``
    is numpy, bit-equal to the reference's; ``device_batch(step, device)``
    puts it on ``device`` as int32 tensors.  With ``sharding`` (a
    ``DeviceMesh`` with ``("data", "model")`` or ``("pod", "data",
    "model")`` axes) it gives ``DTensor``s placed by
    ``distributed.sharding.batch_pspecs``: rows over the dp axes, every rank
    keeping its own rows of the batch it makes (the same on every rank)."""

    def __init__(self, cfg, batch: int, seq_len: int, *, seed: int = 0, sharding=None):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.sharding = sharding

    def host_batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % (2**31 - 1))
        ranks = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = np.minimum(ranks - 1, self.cfg.vocab - 1).astype(np.int32)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}

    def device_batch(self, step: int, device: torch.device) -> dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in self.host_batch(step).items()}
        if self.sharding is None:
            return out
        from repro_torch import convert
        from repro_torch.distributed import sharding as SH

        mi = SH.make_mesh_info(self.sharding)
        return convert.distribute(out, SH.batch_pspecs(self.cfg, out, mi), self.sharding)

    def prefetch(self, start_step: int, n_steps: int, device: torch.device,
                 depth: int = 2) -> Iterator:
        """``(step, device_batch)`` for ``n_steps`` steps from ``start_step``,
        made on a worker thread ``depth`` batches ahead (``prefetch_iter``:
        its exceptions reach the consumer; an abandoned iterator stops it).
        On a CUDA device the worker sets that device first."""
        index = None
        if device.type == "cuda":
            index = device.index if device.index is not None else torch.cuda.current_device()

        def produce(step):
            if index is not None:
                torch.cuda.set_device(index)
            return self.device_batch(step, device)

        yield from prefetch_iter(produce, range(start_step, start_step + n_steps),
                                 depth=depth)
