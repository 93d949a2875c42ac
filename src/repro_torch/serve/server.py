"""``BlazeServer`` — the long-lived multi-tenant front door to a resident
``BlazeSession`` (the port of ``repro/serve/server.py``).

The session/plan/program stack is shaped like a database engine (session →
plan IR → optimizer → compiled programs); this module is its front door.
One server owns ONE resident session holding distributed datasets and
compiled programs (on the card, each program's captured CUDA graphs and
their memory pool), and serves concurrent clients over local HTTP:

* **accept path** (HTTP handler threads): parse → validate → admission
  (``repro_torch.serve.admission``).  Never touches the session, never syncs —
  a submission either queues or gets an immediate typed rejection.
* **dispatch path** (one dispatcher thread): takes plan-compatible
  micro-batches off the queue (``repro_torch.serve.batching``), resolves each to
  the resident program cache (a second client submitting an
  already-compiled plan is a cache hit — 0 compiles, asserted in
  ``tests/test_torch_serve.py``), dispatches every execution asynchronously
  (CUDA graph replays enqueued on the dispatcher's stream), and blocks on
  the host ONCE per batch — one CUDA event recorded after the last group's
  dispatch, then synchronised — before fulfilling futures.  All session
  access happens on this thread, serialized under ``session.lock`` — the
  session stays single-writer by construction.  The thread sets its CUDA
  device to the session's before any work (a new thread starts on device
  0).
* **isolation**: each execution attempt starts with
  ``program.reset_carry()``, inside the supervised attempt, so queries
  sharing a resident program (hash-table or error-feedback carry) cannot
  observe each other's state, and a retried request (a request runs its
  ``iters`` as that many dispatches) starts clean rather than on a carry
  its failed attempt advanced; a query that faults — at plan build,
  dispatch, or result shaping — fails only its own request(s) with a typed
  ``QUERY_ERROR`` while the server keeps serving
  (``tests/test_torch_serve_faults.py``).  Only an injected ``kernel.*``
  fault degrades a program to eager (``session.supervised``); a kernel
  that fails to build or launch fails its request.

Endpoints: ``POST /query`` (``{"tenant", "query", "params"}`` →
``{"ok", "result", "meta"}``), ``GET /stats`` (``ServerStats.snapshot``),
``GET /health``.  Results travel bit-faithfully (``repro_torch.serve.codec``).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import torch

from repro_torch.core import faults
from repro_torch.core.containers import n_nodes, shard_count
from repro_torch.core.session import BlazeSession, _cuda_index
from repro_torch.serve import batching
from repro_torch.serve.admission import (
    AdmissionQueue,
    MalformedRequestError,
    QueryExecutionError,
    Request,
    RequestTimeoutError,
    ServeError,
    ServerClosedError,
    UnknownQueryError,
)
from repro_torch.serve.codec import encode_payload
from repro_torch.serve.queries import (
    DatasetEntry,
    PreparedQuery,
    QuerySpec,
    ServeResources,
    builtin_specs,
    canonical_params,
)
from repro_torch.serve.stats import ServerStats

__all__ = ["BlazeServer"]


class BlazeServer:
    """A resident-session query server (construct → register → ``start``).

    >>> server = BlazeServer(max_queue=64, per_tenant_inflight=8)
    >>> server.register_dataset("edges", edges, n_pages=n)
    >>> server.start()
    >>> BlazeClient(server.url).query("pagerank", {"iters": 10})

    ``max_queue`` bounds the pending queue (admission returns a typed
    ``QUEUE_FULL`` beyond it), ``per_tenant_inflight`` bounds one tenant's
    admitted-but-unfinished requests, ``max_batch`` caps how many
    plan-compatible requests one dispatcher cycle serves, and
    ``request_timeout`` bounds how long the HTTP layer waits for a result.
    Without ``session`` the server makes ``BlazeSession(device, n_shards,
    mesh=mesh)``, on the card unless ``device="cpu"``; ``mesh`` (the
    session's by default) is the topology every query runs on, and
    ``/stats`` reports it (``mesh_shards``, ``mesh_nodes``).  A mesh of
    several processes raises ``NotImplementedError``: a server whose ranks
    follow rank 0's batches is ROADMAP.md, Queue 1 item 6d.
    """

    def __init__(
        self,
        session: BlazeSession | None = None,
        *,
        mesh=None,
        device=None,
        n_shards: int | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_queue: int = 64,
        per_tenant_inflight: int = 8,
        max_batch: int = 8,
        request_timeout: float = 120.0,
        queries: dict[str, QuerySpec] | None = None,
        tune: bool = False,
    ):
        self.session = (session if session is not None
                        else BlazeSession(device, n_shards, mesh=mesh))
        self.mesh = mesh if mesh is not None else self.session.mesh
        if self.mesh.n_ranks > 1:
            raise NotImplementedError(
                f"a server on a mesh of {self.mesh.n_ranks} processes: ranks that "
                "follow rank 0's batches are ROADMAP.md, Queue 1 item 6d")
        self.device = self.mesh.device
        self.stats = ServerStats()
        self.max_batch = max_batch
        self.request_timeout = request_timeout
        self._host, self._port = host, port
        self._queue = AdmissionQueue(max_queue, per_tenant_inflight)
        self._specs = builtin_specs() if queries is None else dict(queries)
        self._datasets: dict[str, DatasetEntry] = {}
        # ``tune=True``: every query's first prepare measures its candidate
        # engine/block configs (program autotuning) and caches winners in
        # the resident session's TuningCache — later prepares of plans
        # containing the same ops reuse them without re-measuring.
        self._resources = ServeResources(self.session, self._datasets, tune=tune,
                                         mesh=self.mesh)
        self._programs: dict[tuple, PreparedQuery] = {}  # the plan cache
        self._running = False
        self._paused = threading.Event()
        # Requests the dispatcher has taken but not yet finished (keyed by
        # request id — Request is an unhashable mutable dataclass) — what
        # the shutdown drain sweeps.  ``_finish_lock`` also guards the
        # per-request ``finished`` flag, making _finish idempotent.
        self._inflight: dict[str, Request] = {}
        self._finish_lock = threading.Lock()
        self._dispatcher: threading.Thread | None = None
        self._httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None

    # -- registration (before or after start) ---------------------------------

    def register_dataset(self, name: str, value, **meta) -> None:
        """Make ``value`` resident under ``name`` (metadata like ``n_pages``
        or ``vocab_size`` rides along for the query specs)."""
        self._datasets[name] = DatasetEntry(name, value, dict(meta))

    def register_query(self, spec: QuerySpec) -> None:
        self._specs[spec.name] = spec

    @property
    def queries(self) -> list[str]:
        return sorted(self._specs)

    @property
    def datasets(self) -> dict[str, DatasetEntry]:
        return self._datasets

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "BlazeServer":
        if self._running:
            return self
        self._running = True
        # The dispatcher thread starts on device 0: it sets the session's
        # device (by index, taken here) before any work.
        index = _cuda_index(self.device) if self.device.type == "cuda" else None
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, args=(index,), name="blaze-dispatch",
            daemon=True,
        )
        self._dispatcher.start()
        self._httpd = _BlazeHTTPServer((self._host, self._port), _Handler)
        self._httpd.blaze = self
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="blaze-http", daemon=True
        )
        self._http_thread.start()
        return self

    def stop(self, drain_timeout: float = 5.0) -> None:
        """Graceful shutdown: refuse new admissions, answer everything still
        queued with a typed ``SHUTDOWN``, let the dispatcher finish the batch
        it holds for up to ``drain_timeout`` seconds, then answer any
        straggler it didn't fulfil with ``SHUTDOWN`` too — no waiter is left
        hanging until its request timeout."""
        if not self._running:
            return
        self._running = False
        for req in self._queue.close():
            if self._finish(req, ok=False):
                req.fail(ServerClosedError("server stopped before dispatch"))
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=drain_timeout)
        # Stragglers: taken by the dispatcher but not finished inside the
        # drain deadline (or orphaned by a dispatcher crash).
        with self._finish_lock:
            stragglers = [
                r for r in self._inflight.values() if not r.finished
            ]
        for req in stragglers:
            if self._finish(req, ok=False):
                req.fail(ServerClosedError("server shut down mid-flight"))
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)

    def __enter__(self) -> "BlazeServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def url(self) -> str:
        assert self._httpd is not None, "server not started"
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def pause_dispatch(self) -> None:
        """Stop draining the queue (admission keeps running) — the test /
        maintenance hook that makes queue saturation and micro-batch
        formation deterministic."""
        self._paused.set()

    def resume_dispatch(self) -> None:
        self._paused.clear()

    @property
    def queue_depth(self) -> int:
        return self._queue.depth

    # -- the accept path (no session access, no syncs) ------------------------

    def submit(self, tenant: str, query: str, params: dict | None = None
               ) -> Request:
        """Validate + admit one query; returns the pending :class:`Request`
        (wait on ``req.done``) or raises a typed :class:`ServeError`."""
        params = {} if params is None else params
        try:
            if not isinstance(tenant, str) or not tenant:
                raise MalformedRequestError("tenant must be a non-empty string")
            if not isinstance(params, dict):
                raise MalformedRequestError("params must be an object")
            spec = self._specs.get(query)
            if spec is None:
                raise UnknownQueryError(
                    f"no query {query!r}; registered: {self.queries}"
                )
            plan_key = spec.plan_key(params)
            req = Request(
                tenant=tenant, query=query, params=params, plan_key=plan_key,
                exec_key=(plan_key, canonical_params(params)),
            )
            self._queue.submit(req)
        except ServeError as e:
            self.stats.on_rejected(e.code)
            raise
        self.stats.on_admitted()
        return req

    def submit_and_wait(self, tenant: str, query: str,
                        params: dict | None = None,
                        timeout: float | None = None):
        """Blocking convenience: submit, wait, return ``(result, meta)`` or
        raise the request's typed error."""
        req = self.submit(tenant, query, params)
        if not req.done.wait(
            self.request_timeout if timeout is None else timeout
        ):
            raise RequestTimeoutError(f"request {req.id} still pending")
        if req.error is not None:
            raise req.error
        return req.result, req.meta

    # -- the dispatch path (sole session user) --------------------------------

    def _dispatch_loop(self, cuda_index: int | None) -> None:
        if cuda_index is not None:
            torch.cuda.set_device(cuda_index)
        while self._running:
            if self._paused.is_set():
                time.sleep(0.02)  # stay responsive to resume/stop
                continue
            batch = self._queue.take_batch(self.max_batch, timeout=0.1)
            if not batch:
                continue
            if self._paused.is_set():
                # Pause landed while we were inside take_batch — put the
                # batch back so pause_dispatch() really holds the backlog.
                for req in self._queue.requeue(batch):
                    if self._finish(req, ok=False):
                        req.fail(ServerClosedError("server stopped"))
                continue
            self._execute_batch(batch)

    def _prepared_for(self, req: Request) -> tuple[PreparedQuery, bool]:
        """(prepared query, was it a plan-cache hit) — the cross-request
        plan-cache reuse point."""
        prepared = self._programs.get(req.plan_key)
        if prepared is not None:
            return prepared, True
        spec = self._specs[req.query]
        prepared = spec.prepare(self._resources, req.params)
        self._programs[req.plan_key] = prepared
        return prepared, False

    def _execute_batch(self, batch: list[Request]) -> None:
        with self._finish_lock:
            for req in batch:
                self._inflight[req.id] = req
        groups = batching.dedup_groups(batch)
        executed: list[tuple[list[Request], PreparedQuery, Any, str]] = []
        served = 0
        # Phase 1: resolve + dispatch every execution group, NO host sync.
        # Each group dispatch runs supervised: transient faults retry with
        # backoff, kernel faults demote the program's pallas nodes to eager
        # and re-dispatch — the query still answers, and the degradation is
        # visible in /stats (recovery block) and the plan's explain().
        for group in groups:
            lead = group[0]
            try:
                with self.session.lock:
                    compiles0 = self.session.stats.program_compiles
                    retries0 = self.session.stats.retries
                    degraded0 = self.session.stats.degraded_nodes
                    prepared, cached = self._prepared_for(lead)

                    def attempt(prepared=prepared, lead=lead):
                        # Isolation, and a retry from the start: shared
                        # resident programs carry per-shard state (hash
                        # tables, int8 residuals) across dispatches, and a
                        # request's iterations are several dispatches.
                        prepared.program.reset_carry()
                        return prepared.run(lead.params)

                    dev = self.session.supervised(
                        attempt, program=prepared.program
                    )
                    compiled = self.session.stats.program_compiles - compiles0
                    retried = self.session.stats.retries - retries0
                    degraded = self.session.stats.degraded_nodes - degraded0
                if retried or degraded:
                    self.stats.on_recovery(retried, degraded)
                self.stats.on_plan(cache_hit=(cached and compiled == 0))
                cache = "hit" if (cached and compiled == 0) else "compile"
                executed.append((group, prepared, dev, cache))
                served += len(group)
            except ServeError as e:
                self._fail_group(group, e)
            except Exception as e:  # noqa: BLE001 — fault isolation boundary
                self._fail_group(group, QueryExecutionError(
                    f"{req_desc(lead)} failed: {type(e).__name__}: {e}"
                ))
        # Phase 2: ONE host sync for the whole batch: every group's replays
        # were enqueued on this thread's stream, so one event after the last
        # covers them all (nothing to wait for on the CPU).
        try:
            if executed and self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
        except Exception as e:  # noqa: BLE001 — device-side failure
            err = QueryExecutionError(f"batch sync failed: {e}")
            for group, _p, _d, _c in executed:
                self._fail_group(group, err)
            executed = []
        # Phase 3: materialise payloads and fan results out (dedup members
        # share their leader's payload).
        dedup = 0
        for group, prepared, dev, cache in executed:
            try:
                payload = prepared.finish(dev)
            except Exception as e:  # noqa: BLE001 — per-group fault isolation
                self._fail_group(group, QueryExecutionError(
                    f"result materialisation failed: {type(e).__name__}: {e}"
                ))
                continue
            for j, req in enumerate(group):
                # Account the finish BEFORE releasing the waiter, so "done
                # is set" implies "counted in stats" (the property suite's
                # drain check relies on this ordering).  A request the
                # shutdown sweep already answered is skipped.
                if not self._finish(req, ok=True):
                    continue
                req.succeed(payload, {
                    "plan_hash": prepared.plan_hash,
                    "cache": cache if j == 0 else "dedup",
                    "batch_size": served,
                    "coalesced": served > 1,
                })
            dedup += len(group) - 1
        if served:
            self.stats.on_dispatch(served, dedup)

    def _fail_group(self, group: list[Request], err: ServeError) -> None:
        for req in group:
            if self._finish(req, ok=False):
                req.fail(err)

    def _finish(self, req: Request, *, ok: bool) -> bool:
        """Account one request's completion exactly once.  Returns False if
        it was already finished (the shutdown sweep racing the dispatcher) —
        the caller must then skip ``succeed``/``fail`` too."""
        with self._finish_lock:
            if req.finished:
                return False
            req.finished = True
            self._inflight.pop(req.id, None)
        self._queue.release(req)
        self.stats.on_finished(ok, time.perf_counter() - req.t_submit)
        return True

    # -- observability ---------------------------------------------------------

    def stats_snapshot(self) -> dict:
        snap = self.stats.snapshot()
        snap["pending_queue"] = self._queue.depth
        snap["resident_programs"] = len(self._programs)
        snap["session"] = self.session.cache_info()
        snap["queries"] = self.queries
        snap["datasets"] = sorted(self._datasets)
        # The port's session owns a device and a shard count, no mesh: one
        # node.  Each resident program's CUDA graphs allocate from one pool
        # it keeps for the server's lifetime (0 on the CPU).
        snap["device"] = str(self.device)
        snap["mesh_shards"] = shard_count(self.mesh)
        snap["mesh_nodes"] = n_nodes(self.mesh)
        resident = [
            {"query": prep.plan_key[0], "plan_hash": prep.plan_hash,
             "pool_reserved_bytes": prep.program.stats.pool_reserved_bytes}
            for prep in self._programs.values()
        ]
        snap["resident"] = resident
        snap["pool_reserved_bytes"] = sum(
            r["pool_reserved_bytes"] for r in resident
        )
        snap["tuning"] = self._tuning_snapshot()
        snap["recovery"] = self._recovery_snapshot()
        return snap

    def _recovery_snapshot(self) -> dict:
        """Fault-recovery provenance for operators: what was injected, how
        each injection was disposed (the conservation ledger), and how often
        this server's dispatches retried or degraded.  ``balanced`` is the
        invariant the chaos suite pins: every injected fault was disposed
        exactly once."""
        ledger = faults.snapshot()
        return {
            "retried_batches": self.stats.retries,
            "degraded_batches": self.stats.degraded,
            "session_retries": self.session.stats.retries,
            "session_degraded_nodes": self.session.stats.degraded_nodes,
            "session_escalations": self.session.stats.escalations,
            "faults_injected": ledger["injected_total"],
            "dispositions": ledger["dispositions"],
            "balanced": ledger["balanced"],
        }

    def _tuning_snapshot(self) -> dict:
        """Per-resident-plan engine/config provenance.

        A plan is "tuned" when at least one of its ops runs a measured (or
        disk-loaded) winner; otherwise it runs entirely on the calibrated
        cost model ("fallback").  ``tuned_plans + fallback_plans`` always
        equals ``resident_programs`` — the conservation the serve tests pin.
        """
        tuned_plans = 0
        per_plan = {}
        for prep in self._programs.values():
            plan = prep.program.plan
            ops, measured = [], False
            for n in (plan.mapreduce_nodes() if plan is not None else []):
                if n.dead or n.cse_of is not None:
                    continue
                cfg = n.tuned
                if cfg is not None:
                    measured = measured or cfg.source in ("measured", "loaded")
                    ops.append({
                        "op": n.idx, "engine": n.engine,
                        "config": cfg.describe(), "source": cfg.source,
                        "wall_ms": (
                            None if cfg.wall_s is None
                            else round(cfg.wall_s * 1e3, 3)
                        ),
                    })
                else:
                    ops.append({
                        "op": n.idx, "engine": n.engine, "config": None,
                        "source": "model",
                        "cost_estimate": n.cost_estimate,
                    })
            if measured:
                tuned_plans += 1
            per_plan[prep.plan_hash] = {
                "query": prep.plan_key[0], "tuned": measured, "ops": ops,
            }
        return {
            "tuned_plans": tuned_plans,
            "fallback_plans": len(self._programs) - tuned_plans,
            "cache": self.session.tuning.snapshot(),
            "plans": per_plan,
        }


def req_desc(req: Request) -> str:
    return f"query {req.query!r} (tenant {req.tenant!r}, id {req.id})"


# -- HTTP layer ----------------------------------------------------------------


class _BlazeHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    blaze: BlazeServer


class _Handler(BaseHTTPRequestHandler):
    server_version = "BlazeServe/6.0"
    protocol_version = "HTTP/1.1"

    # The accept path must stay quiet.
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _send_json(self, status: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        try:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            # Client went away mid-flight: count it, keep serving.
            self.server.blaze.stats.on_disconnect()

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        srv = self.server.blaze
        if self.path == "/stats":
            self._send_json(200, srv.stats_snapshot())
        elif self.path == "/health":
            self._send_json(200, {
                "ok": True, "queries": srv.queries,
                "datasets": sorted(srv.datasets),
            })
        else:
            self._send_json(404, {"ok": False, "error": "NOT_FOUND",
                                  "message": self.path})

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
        srv = self.server.blaze
        if self.path != "/query":
            self._send_json(404, {"ok": False, "error": "NOT_FOUND",
                                  "message": self.path})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length)
            body = json.loads(raw.decode() or "null")
            if not isinstance(body, dict) or not isinstance(
                body.get("query"), str
            ):
                raise MalformedRequestError(
                    'body must be {"query": str, "params"?: obj, '
                    '"tenant"?: str}'
                )
            req = srv.submit(
                body.get("tenant", "default"), body["query"],
                body.get("params") or {},
            )
        except ServeError as e:
            self._send_json(e.http_status, e.payload())
            return
        except (ValueError, UnicodeDecodeError) as e:
            err = MalformedRequestError(f"invalid JSON body: {e}")
            srv.stats.on_rejected(err.code)
            self._send_json(err.http_status, err.payload())
            return
        if not req.done.wait(srv.request_timeout):
            e = RequestTimeoutError(f"request {req.id} still pending")
            self._send_json(e.http_status, e.payload())
            return
        if req.error is not None:
            self._send_json(req.error.http_status, req.error.payload())
            return
        self._send_json(200, {
            "ok": True,
            "result": encode_payload(req.result),
            "meta": req.meta,
        })
