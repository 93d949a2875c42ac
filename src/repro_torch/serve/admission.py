"""Request admission for BlazeServe: typed errors, a bounded pending queue,
and per-tenant in-flight limits (the port's copy of ``repro/serve/admission.py``,
which imports nothing of the JAX package's but the standard library).

Admission is the half of the server that must never block and never touch
the session: it runs on the accept path (HTTP handler threads), so the only
things it may do are O(1) bookkeeping under a lock and an immediate typed
verdict.  Overload is a *response*, not a hang — a full queue raises
:class:`QueueFullError` and a tenant over its in-flight budget raises
:class:`TenantLimitError`, both of which the HTTP layer turns into a 429
with a machine-readable ``error`` code (asserted in ``tests/test_torch_serve.py``:
saturating the queue returns typed rejections in bounded time).

The pending queue is deliberately a plain list under a condition variable
rather than ``queue.Queue``: the micro-batcher (``repro_torch.serve.batching``)
needs to *scan* the backlog for plan-compatible requests, not just pop the
head.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any

__all__ = [
    "AdmissionQueue",
    "BadParamsError",
    "MalformedRequestError",
    "QueryExecutionError",
    "QueueFullError",
    "Request",
    "RequestTimeoutError",
    "ServeError",
    "ServerClosedError",
    "TenantLimitError",
    "UnknownDatasetError",
    "UnknownQueryError",
]


class ServeError(Exception):
    """Base of every typed serving error.

    ``code`` is the stable machine-readable identifier (what clients and
    tests match on); ``http_status`` is what the HTTP layer sends.  The
    string message is advisory detail only.
    """

    code = "SERVE_ERROR"
    http_status = 500

    def payload(self) -> dict:
        return {"ok": False, "error": self.code, "message": str(self)}


class QueueFullError(ServeError):
    """The bounded pending queue is at capacity — back off and retry."""

    code = "QUEUE_FULL"
    http_status = 429


class TenantLimitError(ServeError):
    """This tenant already has its full in-flight budget admitted."""

    code = "TENANT_LIMIT"
    http_status = 429


class UnknownQueryError(ServeError):
    """No registered query spec under that name."""

    code = "UNKNOWN_QUERY"
    http_status = 404


class UnknownDatasetError(ServeError):
    """The query referenced a dataset the server does not hold."""

    code = "UNKNOWN_DATASET"
    http_status = 400


class BadParamsError(ServeError):
    """Parameters failed the query spec's validation."""

    code = "BAD_PARAMS"
    http_status = 400


class MalformedRequestError(ServeError):
    """The request body was not a well-formed query submission."""

    code = "MALFORMED"
    http_status = 400


class QueryExecutionError(ServeError):
    """The query failed while building or running its plan.  Scoped to the
    one request that carried the fault — the server keeps serving."""

    code = "QUERY_ERROR"
    http_status = 500


class RequestTimeoutError(ServeError):
    """The client-side wait expired before the result arrived."""

    code = "TIMEOUT"
    http_status = 504


class ServerClosedError(ServeError):
    """The server is shutting down; the request was not (fully) served."""

    code = "SHUTDOWN"
    http_status = 503


_req_ids = itertools.count(1)


@dataclasses.dataclass
class Request:
    """One admitted query: identity, plan key, and its completion latch.

    ``plan_key`` is the query's *structural* identity (computed by the query
    spec at admission, before any session access): requests with equal
    ``plan_key`` share one compiled program and may micro-batch into one
    dispatch.  ``exec_key`` additionally folds in the non-structural
    parameters — requests with equal ``exec_key`` are the *same* computation
    and coalesce to a single execution (dedup).
    """

    tenant: str
    query: str
    params: dict
    plan_key: tuple
    exec_key: tuple
    id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Any = None
    meta: dict = dataclasses.field(default_factory=dict)
    error: ServeError | None = None
    # Set by the server's ``_finish`` (under its lock) the first time the
    # request is accounted; makes finishing idempotent so the shutdown path
    # can sweep stragglers without double-counting a race with the
    # dispatcher's own fulfilment.
    finished: bool = False

    def succeed(self, result: Any, meta: dict) -> None:
        self.result = result
        self.meta = meta
        self.done.set()

    def fail(self, error: ServeError) -> None:
        self.error = error
        self.done.set()


class AdmissionQueue:
    """Bounded FIFO of pending requests with per-tenant in-flight accounting.

    * ``submit`` admits or raises — it never blocks.  A tenant's in-flight
      count covers queued *and* executing requests and is released only by
      ``release`` (the dispatcher calls it when the request finishes), so a
      tenant cannot monopolise the queue by racing the dispatcher.
    * ``take_batch`` is the dispatcher's blocking pop: the head request plus
      every queued request sharing its ``plan_key`` (scan order preserved),
      up to ``max_batch`` — the raw material of a micro-batched dispatch.
    """

    def __init__(self, max_depth: int = 64, per_tenant: int = 8):
        if max_depth < 1 or per_tenant < 1:
            raise ValueError("max_depth and per_tenant must be >= 1")
        self.max_depth = max_depth
        self.per_tenant = per_tenant
        self._items: list[Request] = []
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._inflight: dict[str, int] = {}
        self._closed = False

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def inflight(self, tenant: str) -> int:
        with self._lock:
            return self._inflight.get(tenant, 0)

    def submit(self, req: Request) -> None:
        with self._nonempty:
            if self._closed:
                raise ServerClosedError("server is shutting down")
            if self._inflight.get(req.tenant, 0) >= self.per_tenant:
                raise TenantLimitError(
                    f"tenant {req.tenant!r} already has "
                    f"{self.per_tenant} requests in flight"
                )
            if len(self._items) >= self.max_depth:
                raise QueueFullError(
                    f"pending queue is at capacity ({self.max_depth})"
                )
            self._inflight[req.tenant] = self._inflight.get(req.tenant, 0) + 1
            self._items.append(req)
            self._nonempty.notify()

    def take_batch(self, max_batch: int, timeout: float) -> list[Request]:
        """Pop the head request plus all queued plan-compatible requests
        (same ``plan_key``), up to ``max_batch``; ``[]`` on timeout."""
        with self._nonempty:
            if not self._items:
                self._nonempty.wait(timeout)
            if not self._items:
                return []
            head = self._items.pop(0)
            batch = [head]
            i = 0
            while len(batch) < max_batch and i < len(self._items):
                if self._items[i].plan_key == head.plan_key:
                    batch.append(self._items.pop(i))
                else:
                    i += 1
            return batch

    def requeue(self, reqs: list[Request]) -> list[Request]:
        """Reinsert already-admitted requests at the queue head (the
        dispatcher noticed a pause after taking them).  Bypasses admission
        limits — their budgets are still held.  If the queue has closed in
        the meantime the requests cannot be requeued and are returned for
        the caller to fail."""
        with self._nonempty:
            if self._closed:
                return list(reqs)
            self._items[:0] = reqs
            self._nonempty.notify()
            return []

    def release(self, req: Request) -> None:
        """The request finished (either way): return its tenant budget."""
        with self._lock:
            n = self._inflight.get(req.tenant, 0) - 1
            if n > 0:
                self._inflight[req.tenant] = n
            else:
                self._inflight.pop(req.tenant, None)

    def close(self) -> list[Request]:
        """Refuse further admissions; drain and return whatever is queued."""
        with self._nonempty:
            self._closed = True
            drained, self._items = self._items, []
            self._nonempty.notify_all()
            return drained
