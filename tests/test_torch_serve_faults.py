"""The port's serving layer under faults, mirroring
``tests/test_serve_faults.py`` on the CPU.

A fault must be exactly as big as the request that carried it: a raising
mapper fails its own query with a typed ``QUERY_ERROR`` while the server
keeps serving and the resident program cache stays uncorrupted (asserted by
a follow-up query that must succeed with zero new compiles).  Transport
faults — malformed bodies, unknown queries, clients disconnecting
mid-flight — are likewise absorbed without taking the service down.
"""
from __future__ import annotations

import json
import re
import socket
import urllib.parse

import numpy as np
import pytest
import torch

from repro.data import synthetic as S
from repro_torch.serve import (
    BadParamsError,
    BlazeClient,
    BlazeServer,
    PreparedQuery,
    QueryExecutionError,
    QuerySpec,
    RemoteServeError,
)
from repro_torch.serve.queries import _int


class FaultyMapperQuery(QuerySpec):
    """A pi-like query whose mapper raises at plan-build time when asked to
    (``params["boom"]``): discovery runs the step once, eagerly, at
    ``prog.build``, so a buggy mapper detonates while the plan is being
    discovered, inside the dispatcher, for one request."""

    name = "faulty"

    def plan_key(self, params):
        # "boom" is structural on purpose: the faulty variant must not be
        # served from the healthy variant's resident program.
        return ("faulty", _int(params, "n_samples", 512, 1),
                bool(params.get("boom", False)))

    def prepare(self, res, params):
        from repro_torch.core.algorithms.pi import _program_step

        n = _int(params, "n_samples", 512, 1)
        if params.get("boom"):
            def bad_step(ctx, s):
                raise ValueError("injected mapper fault")
            step = bad_step
            state0 = {"counts": torch.zeros((1,), dtype=torch.int32, device=res.device)}
        else:
            step, state0 = _program_step(n, "eager", res.device)
        prog = res.session.program(step)
        plan = prog.build(state0)

        def run(p):
            return prog(state0, 1)

        def finish(dev):
            return {"counts": dev["counts"].cpu().numpy()}

        return PreparedQuery(self.plan_key(params), plan.hash, prog, run,
                             finish)


class FlakyRunQuery(QuerySpec):
    """Same plan for every request; ``params["fail"]`` makes one request's
    dispatch raise — the fault and the healthy requests share one resident
    program, so isolation is about the request, not the plan."""

    name = "flaky"

    def plan_key(self, params):
        return ("flaky", 512)

    def prepare(self, res, params):
        from repro_torch.core.algorithms.pi import _program_step

        step, state0 = _program_step(512, "eager", res.device)
        prog = res.session.program(step)
        plan = prog.build(state0)

        def run(p):
            if p.get("fail"):
                raise RuntimeError("injected dispatch fault")
            return prog(state0, 1)

        def finish(dev):
            return {"counts": dev["counts"].cpu().numpy()}

        return PreparedQuery(self.plan_key(params), plan.hash, prog, run,
                             finish)


@pytest.fixture()
def server():
    srv = BlazeServer(device="cpu", max_queue=64, per_tenant_inflight=16, max_batch=4)
    lines, _ = S.zipf_corpus(128, 8, 64, seed=3)
    srv.register_dataset("lines", lines, vocab_size=64)
    srv.register_query(FaultyMapperQuery())
    srv.register_query(FlakyRunQuery())
    srv.start()
    yield srv
    srv.stop()


def test_raising_mapper_fails_only_its_request(server):
    # Healthy baseline first: compiles the good plan.
    r1, _ = server.submit_and_wait("alice", "faulty", {"n_samples": 512})
    compiles = server.stats.compiles

    with pytest.raises(QueryExecutionError) as ei:
        server.submit_and_wait("bob", "faulty",
                               {"n_samples": 512, "boom": True})
    assert "injected mapper fault" in str(ei.value)

    # The server keeps serving and the resident cache is uncorrupted:
    # the follow-up healthy query succeeds with ZERO new compiles and the
    # same payload.
    r2, meta2 = server.submit_and_wait("carol", "faulty", {"n_samples": 512})
    assert meta2["cache"] == "hit"
    # The detonation happened during plan build — nothing was compiled by
    # it and nothing needed recompiling after it.
    assert server.stats.compiles == compiles
    assert np.array_equal(r1["counts"], r2["counts"])
    snap = server.stats.snapshot()
    assert snap["failed"] == 1 and snap["completed"] == 2
    assert snap["completed"] + snap["failed"] + snap["queued"] == \
        snap["submitted"]


def test_dispatch_fault_shares_plan_but_not_fate(server):
    r1, _ = server.submit_and_wait("alice", "flaky", {})
    compiles = server.stats.compiles
    with pytest.raises(QueryExecutionError):
        server.submit_and_wait("bob", "flaky", {"fail": True})
    r2, meta2 = server.submit_and_wait("carol", "flaky", {})
    assert meta2["cache"] == "hit"
    assert server.stats.compiles == compiles  # fault compiled nothing new
    assert np.array_equal(r1["counts"], r2["counts"])


def test_fault_in_batch_fails_only_its_group(server):
    """Micro-batched neighbours of a faulty request still complete."""
    server.pause_dispatch()
    good = [server.submit(f"t{i}", "flaky", {"tag": i}) for i in range(3)]
    bad = server.submit("t9", "flaky", {"fail": True})
    server.resume_dispatch()
    for r in good:
        assert r.done.wait(120)
        assert r.error is None, r.error
    assert bad.done.wait(120)
    assert isinstance(bad.error, QueryExecutionError)


def test_malformed_and_typed_http_errors(server):
    client = BlazeClient(server.url, tenant="alice")

    with pytest.raises(RemoteServeError) as ei:
        client.query("no-such-query", {})
    assert ei.value.code == "UNKNOWN_QUERY" and ei.value.status == 404

    with pytest.raises(RemoteServeError) as ei:
        client.query("wordcount", {"dataset": "no-such-dataset"})
    assert ei.value.code == "UNKNOWN_DATASET" and ei.value.status == 400

    with pytest.raises(RemoteServeError) as ei:
        client.query("faulty", {"n_samples": -3})
    assert ei.value.code == "BAD_PARAMS" and ei.value.status == 400

    # Raw malformed JSON body -> typed 400, not a hang or a 500.
    host, port = _host_port(server.url)
    body = b"{this is not json"
    req = (
        b"POST /query HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
        b"\r\nContent-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body
    )
    with socket.create_connection((host, port), timeout=30) as sock:
        sock.sendall(req)
        resp = _recv_response(sock)
    assert resp.startswith("HTTP/1.1 400")
    payload = json.loads(resp.split("\r\n\r\n", 1)[1])
    assert payload["error"] == "MALFORMED"

    # A non-object body is malformed too (not a crash).
    with socket.create_connection((host, port), timeout=30) as sock:
        good = json.dumps([1, 2, 3]).encode()
        sock.sendall(
            b"POST /query HTTP/1.1\r\nHost: x\r\nContent-Length: "
            + str(len(good)).encode() + b"\r\n\r\n" + good
        )
        resp = _recv_response(sock)
    assert resp.startswith("HTTP/1.1 400")

    # After all that abuse the server still serves real queries.
    r, _ = client.query("faulty", {"n_samples": 512})
    assert r["counts"].shape == (1,)


def test_client_disconnect_mid_flight(server):
    """A client that submits and vanishes must not take the server down —
    its query still completes server-side; later clients are unaffected."""
    completed0 = server.stats.snapshot()["completed"]
    host, port = _host_port(server.url)
    body = json.dumps({
        "tenant": "ghost", "query": "flaky", "params": {"tag": "ghost"},
    }).encode()
    with socket.create_connection((host, port), timeout=30) as sock:
        sock.sendall(
            b"POST /query HTTP/1.1\r\nHost: x\r\nContent-Type: "
            b"application/json\r\nContent-Length: "
            + str(len(body)).encode() + b"\r\n\r\n" + body
        )
        # Hang up without reading the response.
    # The ghost's query still runs to completion server-side.
    deadline = 120.0
    import time
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < deadline:
        if server.stats.snapshot()["completed"] >= completed0 + 1:
            break
        time.sleep(0.05)
    assert server.stats.snapshot()["completed"] >= completed0 + 1
    # And the server is fully healthy for the next client.
    client = BlazeClient(server.url, tenant="alive")
    r, _ = client.query("flaky", {})
    assert r["counts"].shape == (1,)
    snap = server.stats.snapshot()
    assert snap["completed"] + snap["failed"] + snap["queued"] == \
        snap["submitted"]


def test_bad_params_never_reach_the_queue(server):
    """Validation failures are rejected at admission: nothing is queued,
    nothing dispatched, conservation still holds."""
    dispatches0 = server.stats.snapshot()["dispatches"]
    with pytest.raises(BadParamsError):
        server.submit("alice", "faulty", {"n_samples": "lots"})
    snap = server.stats.snapshot()
    assert snap["queued"] == 0
    assert snap["dispatches"] == dispatches0
    assert snap["completed"] + snap["failed"] + snap["queued"] == \
        snap["submitted"]


def _host_port(url: str) -> tuple[str, int]:
    p = urllib.parse.urlparse(url)
    return p.hostname, p.port


def _recv_response(sock: socket.socket) -> str:
    """Read one full HTTP response: headers, then Content-Length bytes of
    body.  A single recv() may return a partial body under load."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            return buf.decode()
        buf += chunk
    head, body = buf.split(b"\r\n\r\n", 1)
    m = re.search(rb"content-length:\s*(\d+)", head, re.I)
    want = int(m.group(1)) if m else 0
    while len(body) < want:
        chunk = sock.recv(65536)
        if not chunk:
            break
        body += chunk
    return (head + b"\r\n\r\n" + body).decode()
