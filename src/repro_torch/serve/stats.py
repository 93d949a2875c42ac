"""``ServerStats`` — the serving layer's observability surface (the port's
copy of ``repro/serve/stats.py``).

Counters are grouped by the invariants the property suite holds them to
(``tests/test_torch_serve_property.py``), which are also the operator's sanity
checks on ``/stats``:

* **conservation** — every submission ends in exactly one bucket:
  ``completed + failed + queued == submitted`` at every instant (updates
  that move a request between buckets happen under one lock);
* **plan accounting** — every *executed* plan resolution either hit the
  server's program cache or compiled: ``cache_hits + compiles ==
  dispatched_plans`` (deduplicated requests ride a batchmate's execution
  and are counted in ``dedup_hits``/``coalesced_queries`` instead);
* **ordering** — ``p50_ms <= p99_ms`` (both cut from one snapshot of the
  same latency window).

``queued`` is the admission gauge: requests admitted but not yet finished
(pending *or* executing) — what a load balancer would shed on.  Latency is
measured submit→fulfil over a sliding window of the most recent
``window`` completed requests; throughput is completed requests per second
of server uptime.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

__all__ = ["ServerStats"]


class ServerStats:
    """Thread-safe serving counters + latency percentiles.

    All transitions take the single internal lock, so any two counters read
    in one :meth:`snapshot` are mutually consistent.
    """

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._latencies: deque[float] = deque(maxlen=window)
        # -- conservation: submitted == completed + failed + queued ----------
        self.submitted = 0  # every request that reached admission control
        self.queued = 0  # admitted, not yet finished (pending or executing)
        self.completed = 0  # finished with a result
        self.failed = 0  # finished with a typed error (incl. rejections)
        # -- rejection detail (subsets of failed) ----------------------------
        self.rejected_queue_full = 0
        self.rejected_tenant_limit = 0
        # -- dispatch / micro-batching ---------------------------------------
        self.dispatches = 0  # dispatcher cycles (one batch each)
        self.batched_dispatches = 0  # cycles that served >= 2 requests
        self.coalesced_queries = 0  # requests served beyond a batch's first
        self.dedup_hits = 0  # requests that shared an identical execution
        # -- plan accounting: cache_hits + compiles == dispatched_plans ------
        self.dispatched_plans = 0  # executed plan resolutions
        self.cache_hits = 0  # resolutions served by an existing program
        self.compiles = 0  # resolutions that compiled a new program
        # -- transport -------------------------------------------------------
        self.disconnects = 0  # clients gone before their response was written
        # -- fault recovery ------------------------------------------------------
        self.retries = 0  # supervised batch dispatches that re-attempted
        self.degraded = 0  # batch dispatches that demoted pallas -> eager

    # -- transitions ---------------------------------------------------------

    def on_admitted(self) -> None:
        with self._lock:
            self.submitted += 1
            self.queued += 1

    def on_rejected(self, code: str) -> None:
        with self._lock:
            self.submitted += 1
            self.failed += 1
            if code == "QUEUE_FULL":
                self.rejected_queue_full += 1
            elif code == "TENANT_LIMIT":
                self.rejected_tenant_limit += 1

    def on_finished(self, ok: bool, latency_s: float) -> None:
        with self._lock:
            self.queued -= 1
            if ok:
                self.completed += 1
                self._latencies.append(latency_s)
            else:
                self.failed += 1

    def on_dispatch(self, served: int, dedup: int) -> None:
        with self._lock:
            self.dispatches += 1
            if served >= 2:
                self.batched_dispatches += 1
                self.coalesced_queries += served - 1
            self.dedup_hits += dedup

    def on_plan(self, cache_hit: bool) -> None:
        with self._lock:
            self.dispatched_plans += 1
            if cache_hit:
                self.cache_hits += 1
            else:
                self.compiles += 1

    def on_disconnect(self) -> None:
        with self._lock:
            self.disconnects += 1

    def on_recovery(self, retried: int, degraded: int) -> None:
        with self._lock:
            self.retries += retried
            self.degraded += degraded

    # -- reads ---------------------------------------------------------------

    def percentiles(self) -> tuple[float, float]:
        """(p50, p99) latency in milliseconds over the sliding window."""
        with self._lock:
            lat = list(self._latencies)
        if not lat:
            return 0.0, 0.0
        a = np.asarray(lat) * 1e3
        return float(np.percentile(a, 50)), float(np.percentile(a, 99))

    def snapshot(self) -> dict:
        """One consistent view of every counter plus derived gauges —
        the ``/stats`` endpoint's payload."""
        with self._lock:
            lat = np.asarray(self._latencies) * 1e3
            uptime = time.perf_counter() - self._t0
            snap = {
                "submitted": self.submitted,
                "queued": self.queued,
                "completed": self.completed,
                "failed": self.failed,
                "rejected_queue_full": self.rejected_queue_full,
                "rejected_tenant_limit": self.rejected_tenant_limit,
                "dispatches": self.dispatches,
                "batched_dispatches": self.batched_dispatches,
                "coalesced_queries": self.coalesced_queries,
                "dedup_hits": self.dedup_hits,
                "dispatched_plans": self.dispatched_plans,
                "cache_hits": self.cache_hits,
                "compiles": self.compiles,
                "disconnects": self.disconnects,
                "retries": self.retries,
                "degraded": self.degraded,
                "uptime_s": uptime,
            }
        if lat.size:
            snap["p50_ms"] = float(np.percentile(lat, 50))
            snap["p99_ms"] = float(np.percentile(lat, 99))
            snap["mean_ms"] = float(lat.mean())
        else:
            snap["p50_ms"] = snap["p99_ms"] = snap["mean_ms"] = 0.0
        snap["throughput_qps"] = (
            snap["completed"] / uptime if uptime > 0 else 0.0
        )
        return snap
