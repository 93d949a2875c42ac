"""The port's serving layer (``repro_torch.serve``), mirroring
``tests/test_serve.py`` on the CPU: plan-cache reuse, micro-batching,
bit-equality with direct session execution, and bounded-queue behaviour.

The acceptance workload (3 tenants x 20 mixed queries over pi / pagerank /
wordcount) must compile exactly 3 programs — one per distinct plan — while
coalescing compatible concurrent queries into micro-batched dispatches, and
every served result must be bit-equal to running the same query directly
(``repro_torch.serve.run_direct``) against a fresh session.

Beyond the mirror: each of the six built-in queries, engines ``eager`` and
``pallas``, through the port's ``run_direct`` and ``repro.serve.run_direct``
on the same numpy datasets (integers exactly; floats within the tolerances
of ``tests/test_torch_program.py``: PageRank 1e-5 max-abs, k-means centres
1e-4 and inertia 1e-4 relative, GMM α, μ, Σ 1e-4 and log-likelihood 1e-5
relative, kNN distances ``rtol=1e-6``); requests that differ only in
``iters`` share one plan and dispatch its one-iteration block ``iters``
times (one CUDA graph a plan on the card); a retried request restarts with
its carry reset; the dispatcher holds ``session.lock``; the codec is bit
faithful for numpy arrays and scalars and torch tensors (bf16 included);
the launcher; and neither ``repro_torch.serve`` nor
``repro_torch.launch.serve`` imports JAX or ``repro``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.session import BlazeSession as JaxSession
from repro.data import synthetic as S
from repro.serve import DatasetEntry as JaxDatasetEntry
from repro.serve import run_direct as jax_run_direct
from repro_torch.core import BlazeSession
from repro_torch.core import faults
from repro_torch.core.algorithms import pagerank
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_node_data_mesh
from repro_torch.serve import (
    BlazeClient,
    BlazeServer,
    DatasetEntry,
    PreparedQuery,
    QuerySpec,
    QueueFullError,
    RemoteServeError,
    TenantLimitError,
    decode_payload,
    encode_payload,
    run_direct,
)

VOCAB = 64


def _register(server: BlazeServer) -> None:
    edges = S.rmat_edges(6, seed=3)
    lines, _ = S.zipf_corpus(128, 8, VOCAB, seed=3)
    server.register_dataset("edges", edges, n_pages=64)
    server.register_dataset("lines", lines, vocab_size=VOCAB)


def _mixed_workload() -> list[tuple[str, dict]]:
    """20 queries over 3 distinct plans (pi, pagerank, wordcount); pagerank
    varies ``iters`` — same plan, different inputs — to exercise honest
    coalescing, not just dedup."""
    work: list[tuple[str, dict]] = []
    for i in range(20):
        kind = i % 3
        if kind == 0:
            work.append(("pi", {"n_samples": 2048, "iters": 1 + i % 2}))
        elif kind == 1:
            work.append(("pagerank", {"iters": 2 + i % 4}))
        else:
            work.append(("wordcount", {"iters": 1}))
    return work


def _cpu_session(**kw):
    return BlazeSession(device="cpu", **kw)


@pytest.fixture()
def server():
    srv = BlazeServer(device="cpu", max_queue=256, per_tenant_inflight=64,
                      max_batch=8)
    _register(srv)
    srv.start()
    yield srv
    srv.stop()


def _assert_same_payload(got: dict, want: dict, what) -> None:
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float):
            assert g == w, (what, key)
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, (what, key)
            assert np.array_equal(np.asarray(g), np.asarray(w)), (what, key)


def test_acceptance_three_tenants_twenty_queries(server):
    """The headline contract: 3 tenants x 20 queries, 3 plans -> exactly 3
    compiles, >= 1 micro-batched dispatch, bit-equal results."""
    tenants = ("alice", "bob", "carol")
    work = _mixed_workload()

    server.pause_dispatch()  # let the backlog form so batches are real
    reqs = [
        (t, q, p, server.submit(t, q, p))
        for t in tenants
        for (q, p) in work
    ]
    assert server.queue_depth == len(tenants) * len(work)
    server.resume_dispatch()
    for _t, _q, _p, r in reqs:
        assert r.done.wait(300), "request never completed"
        assert r.error is None, f"unexpected failure: {r.error}"

    # Exactly one compile per distinct plan — resubmissions and other
    # tenants ride the resident programs.
    assert server.stats.compiles == 3
    assert server.session.stats.program_compiles == 3
    assert server.stats.cache_hits + server.stats.compiles == \
        server.stats.dispatched_plans
    # Concurrent compatible queries really coalesced.
    assert server.stats.batched_dispatches >= 1
    assert server.stats.coalesced_queries >= 1
    assert server.stats.completed == len(reqs)
    assert server.stats.failed == 0

    # Bit-equality: every distinct (query, params) matches a fresh direct
    # session run of the same prepared query.
    distinct = {(q, tuple(sorted(p.items()))): (q, p) for _t, q, p, _r in reqs}
    for q, p in distinct.values():
        direct = run_direct(_cpu_session(), server.datasets, q, p)
        served = next(
            r.result for _t, q2, p2, r in reqs if (q2, p2) == (q, p)
        )
        _assert_same_payload(served, direct, (q, p))
    # And every request with identical params got the identical payload.
    for _t, q, p, r in reqs:
        ref = next(
            r2.result for _t2, q2, p2, r2 in reqs if (q2, p2) == (q, p)
        )
        for key in ref:
            assert np.array_equal(
                np.asarray(r.result[key]), np.asarray(ref[key])
            )


def test_http_concurrency_stress(server):
    """N client threads x M queries over real HTTP: all succeed, compile
    count == distinct plan count, per-thread results agree."""
    n_threads, m_queries = 6, 5
    work = _mixed_workload()[: m_queries]
    results: dict[int, list] = {}
    errors: list[Exception] = []

    def worker(tid: int):
        client = BlazeClient(server.url, tenant=f"t{tid % 3}")
        out = []
        try:
            for q, p in work:
                r, meta = client.query(q, p)
                out.append((q, r, meta))
        except Exception as e:  # noqa: BLE001 — surfaced via `errors`
            errors.append(e)
        results[tid] = out

    threads = [
        threading.Thread(target=worker, args=(i,)) for i in range(n_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert all(len(results[i]) == len(work) for i in range(n_threads))

    # compile count == number of distinct plans in the workload
    distinct_plans = {q for q, _p in work}
    assert server.stats.compiles == len(distinct_plans)
    # identical queries agree bit-for-bit across threads
    for j in range(len(work)):
        _q, ref, _m = results[0][j]
        for i in range(1, n_threads):
            _q2, got, _m2 = results[i][j]
            for key in ref:
                assert np.array_equal(np.asarray(ref[key]),
                                      np.asarray(got[key]))
    snap = server.stats.snapshot()
    assert snap["completed"] + snap["failed"] + snap["queued"] == \
        snap["submitted"]


def test_cached_resubmit_compiles_nothing(server):
    _r1, meta1 = server.submit_and_wait("alice", "pagerank", {"iters": 3})
    compiles = server.stats.compiles
    _r2, meta2 = server.submit_and_wait("bob", "pagerank", {"iters": 7})
    assert meta1["cache"] == "compile"
    assert meta2["cache"] == "hit"
    assert meta2["plan_hash"] == meta1["plan_hash"]
    assert server.stats.compiles == compiles  # 0 new compiles


def test_identical_concurrent_queries_dedup(server):
    server.pause_dispatch()
    reqs = [
        server.submit(f"t{i}", "pi", {"n_samples": 1024, "iters": 1})
        for i in range(4)
    ]
    server.resume_dispatch()
    for r in reqs:
        assert r.done.wait(120) and r.error is None
    metas = [r.meta["cache"] for r in reqs]
    assert metas.count("dedup") == 3, metas  # one execution served four
    assert server.stats.dedup_hits >= 3
    for r in reqs[1:]:
        assert np.array_equal(r.result["counts"], reqs[0].result["counts"])


def test_queue_saturation_returns_typed_error_fast():
    srv = BlazeServer(device="cpu", max_queue=4, per_tenant_inflight=16,
                      max_batch=4)
    _register(srv)
    srv.start()
    try:
        srv.pause_dispatch()
        held = [
            srv.submit("alice", "pi", {"n_samples": 512, "iters": 1 + i})
            for i in range(4)
        ]
        t0 = time.perf_counter()
        with pytest.raises(QueueFullError):
            srv.submit("bob", "pi", {"n_samples": 512, "iters": 9})
        assert time.perf_counter() - t0 < 1.0, "rejection must not hang"
        # over HTTP the same overload is a typed 429, still bounded time
        client = BlazeClient(srv.url, tenant="carol")
        t0 = time.perf_counter()
        with pytest.raises(RemoteServeError) as ei:
            client.query("pi", {"n_samples": 512, "iters": 8})
        assert ei.value.code == "QUEUE_FULL"
        assert ei.value.status == 429
        assert time.perf_counter() - t0 < 2.0
        srv.resume_dispatch()
        for r in held:
            assert r.done.wait(120) and r.error is None
        snap = srv.stats.snapshot()
        assert snap["rejected_queue_full"] == 2
        assert snap["completed"] + snap["failed"] + snap["queued"] == \
            snap["submitted"]
    finally:
        srv.stop()


def test_per_tenant_limit():
    srv = BlazeServer(device="cpu", max_queue=64, per_tenant_inflight=2,
                      max_batch=4)
    _register(srv)
    srv.start()
    try:
        srv.pause_dispatch()
        held = [
            srv.submit("alice", "pi", {"n_samples": 512, "iters": 1 + i})
            for i in range(2)
        ]
        with pytest.raises(TenantLimitError):
            srv.submit("alice", "pi", {"n_samples": 512, "iters": 9})
        # another tenant is unaffected by alice's budget
        other = srv.submit("bob", "pi", {"n_samples": 512, "iters": 1})
        srv.resume_dispatch()
        for r in held + [other]:
            assert r.done.wait(120) and r.error is None
        # budget released after completion: alice can submit again
        _r, _m = srv.submit_and_wait("alice", "pi",
                                     {"n_samples": 512, "iters": 1})
    finally:
        srv.stop()


def test_stats_endpoint_shape(server):
    server.submit_and_wait("alice", "pi", {"n_samples": 512, "iters": 1})
    snap = BlazeClient(server.url).stats()
    for key in (
        "submitted", "queued", "completed", "failed", "dispatches",
        "batched_dispatches", "coalesced_queries", "dedup_hits",
        "dispatched_plans", "cache_hits", "compiles", "p50_ms", "p99_ms",
        "throughput_qps", "pending_queue", "resident_programs", "session",
    ):
        assert key in snap, key
    assert snap["p50_ms"] <= snap["p99_ms"]
    assert snap["resident_programs"] >= 1
    # The port's fields: its shard count and one node in place of a mesh,
    # and each resident program's graph pool (none on the CPU).
    assert snap["mesh_shards"] == 1 and snap["mesh_nodes"] == 1
    assert snap["device"] == "cpu"
    assert len(snap["resident"]) == snap["resident_programs"]
    assert snap["pool_reserved_bytes"] == sum(
        r["pool_reserved_bytes"] for r in snap["resident"]) == 0
    # A server over a (2x4) mesh reports its topology, and its queries run
    # there (PageRank's sums hierarchical).
    mesh = make_node_data_mesh(2, n_shards=8, device="cpu")
    with BlazeServer(mesh=mesh, max_batch=4) as srv:
        _register(srv)
        srv.submit_and_wait("alice", "pagerank", {"iters": 2})
        snap = BlazeClient(srv.url).stats()
        assert snap["mesh_shards"] == 8 and snap["mesh_nodes"] == 2
        (prep,) = srv._programs.values()
        assert prep.program.plan.n_nodes == 2
        assert any(n.hier for n in prep.program.plan.mapreduce_nodes())


# -- the six queries against the reference's run_direct -------------------------


def _datasets():
    edges = S.rmat_edges(6, seed=3)
    lines, _ = S.zipf_corpus(128, 8, VOCAB, seed=3)
    points, _ = S.cluster_points(500, 3, 4, seed=1)
    return {"edges": (edges, {"n_pages": 64}),
            "lines": (lines, {"vocab_size": VOCAB}),
            "points": (points, {})}


QUERIES = {
    "pi": {"n_samples": 2048, "iters": 2},
    "pagerank": {"iters": 4},
    "wordcount": {"iters": 2},
    "kmeans": {"k": 4, "iters": 3, "seed": 1},
    "gmm": {"k": 3, "iters": 3, "seed": 2},
    "knn": {"k": 7, "query": [0.25, -0.5, 1.0]},
}


@pytest.mark.parametrize("engine", ("eager", "pallas"))
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_run_direct_matches_jax(query, engine):
    ds = _datasets()
    params = {**QUERIES[query], "engine": engine}
    got = run_direct(_cpu_session(), {k: DatasetEntry(k, v, m) for k, (v, m) in ds.items()},
                     query, params)
    jsess = JaxSession()
    want = jax_run_direct(jsess, jsess.mesh,
                          {k: JaxDatasetEntry(k, v, m) for k, (v, m) in ds.items()},
                          query, params)
    assert set(got) == set(want)
    if query == "pi":
        assert got["pi"] == want["pi"]
        np.testing.assert_array_equal(got["counts"], np.asarray(want["counts"]))
    elif query == "wordcount":
        np.testing.assert_array_equal(got["keys"], np.asarray(want["keys"]))
        np.testing.assert_array_equal(got["counts"], np.asarray(want["counts"]))
        assert int(got["counts"].sum()) == 2 * int((ds["lines"][0] >= 0).sum())
    elif query == "pagerank":
        assert float(np.abs(got["scores"] - np.asarray(want["scores"])).max()) <= 1e-5
        assert abs(got["delta"] - want["delta"]) <= 1e-5
    elif query == "kmeans":
        assert float(np.abs(got["centers"] - np.asarray(want["centers"])).max()) <= 1e-4
        assert abs(got["inertia"] - want["inertia"]) <= 1e-4 * abs(want["inertia"])
    elif query == "gmm":
        for name in ("alpha", "mu", "sigma"):
            np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                       atol=1e-4, rtol=0, err_msg=name)
        assert abs(got["log_likelihood"] - want["log_likelihood"]) <= 1e-5 * abs(
            want["log_likelihood"])
    else:  # knn: the same rows, distances to rtol 1e-6
        assert {tuple(r) for r in got["neighbors"].tolist()} == {
            tuple(r) for r in np.asarray(want["neighbors"]).tolist()}
        np.testing.assert_allclose(np.sort(got["distances"]),
                                   np.sort(np.asarray(want["distances"])), rtol=1e-6)


# -- the port's hazards ---------------------------------------------------------


def test_compile_count_unchanged_when_iters_varies(server):
    """``iters`` is not structural: every request of a plan dispatches the
    one-iteration block (one graph on the card) ``iters`` times."""
    pts, _ = S.cluster_points(300, 3, 4, seed=5)
    server.register_dataset("points", pts)
    iters = [1, 2, 3, 4, 5, 6, 7]
    for i in iters:
        server.submit_and_wait("a", "pagerank", {"iters": i})
        server.submit_and_wait("a", "kmeans", {"k": 4, "iters": i, "seed": i % 3})
    assert server.stats.compiles == 2
    assert server.session.stats.program_compiles == 2
    for prep in server._programs.values():
        st = prep.program.stats
        assert st.compiles == 1
        assert st.dispatches == st.iterations == sum(iters)
    # Chained dispatches give what one block of ``iters`` iterations gives.
    got, _ = server.submit_and_wait("a", "pagerank", {"iters": 5})
    block = pagerank(server.datasets["edges"].value, 64, tol=0.0, max_iters=5,
                     mode="program", unroll=5, session=_cpu_session())
    assert block.dispatches == 1
    assert np.array_equal(got["scores"], block.scores)


def test_retry_restarts_the_request_with_its_carry_reset(server):
    """A transient ``dispatch`` fault at a request's second dispatch (of
    three): the supervised attempt resets the carry before it runs again,
    so the word counts are those of a fault-free run, not 4/3 of them."""
    faults.reset(env=False)
    try:
        ref, _ = server.submit_and_wait("a", "wordcount", {"iters": 3})
        faults.configure("dispatch", at=2)
        got, meta = server.submit_and_wait("b", "wordcount", {"iters": 3})
        snap = faults.snapshot()
    finally:
        faults.reset(env=False)
    assert meta["cache"] == "hit"
    assert snap["dispositions"]["retried"] == 1 and snap["balanced"]
    assert server.stats.retries == 1
    np.testing.assert_array_equal(got["keys"], ref["keys"])
    np.testing.assert_array_equal(got["counts"], ref["counts"])
    lines = server.datasets["lines"].value
    assert int(got["counts"].sum()) == 3 * int((lines >= 0).sum())


class _BlockingQuery(QuerySpec):
    """A query whose ``run`` waits until released, recording whether the
    session's lock was held by the thread running it."""

    name = "blocking"

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.seen: dict = {}

    def plan_key(self, params):
        return ("blocking",)

    def prepare(self, res, params):
        from repro_torch.core.algorithms.pi import _program_step

        step, state0 = _program_step(256, "eager", res.device)
        prog = res.session.program(step)
        plan = prog.build(state0)

        def run(p):
            self.seen["thread"] = threading.current_thread().name
            self.entered.set()
            assert self.release.wait(60)
            return prog(state0, 1)

        def finish(dev):
            return {"counts": dev["counts"].numpy()}

        return PreparedQuery(self.plan_key(params), plan.hash, prog, run, finish)


def test_dispatcher_holds_the_session_lock(server):
    spec = _BlockingQuery()
    server.register_query(spec)
    req = server.submit("a", "blocking", {})
    assert spec.entered.wait(60)
    try:
        # The dispatcher is inside run(): the lock is taken by it.
        assert not server.session.lock.acquire(blocking=False)
    finally:
        spec.release.set()
    assert req.done.wait(60) and req.error is None
    assert spec.seen["thread"] == "blaze-dispatch"
    assert server.session.lock.acquire(blocking=False)
    server.session.lock.release()


# -- codec ------------------------------------------------------------------


def test_codec_is_bit_faithful_for_numpy_and_torch():
    rng = np.random.RandomState(0)
    bf = torch.from_numpy(rng.randn(3, 5).astype(np.float32)).to(torch.bfloat16)
    payload = {
        "f32": rng.randn(4, 3).astype(np.float32),
        "f64_be": rng.randn(5).astype(">f8"),
        "i64": np.arange(-3, 9, dtype=np.int64),
        "scalar": np.float32(0.1),
        "t_f32": torch.from_numpy(rng.randn(7).astype(np.float32)),
        "t_i32": torch.arange(10, dtype=torch.int32).reshape(2, 5),
        "t_0d": torch.tensor(1.0 / 3.0, dtype=torch.float32),
        "t_bf16": bf,
        "t_bf16_empty": torch.empty((0, 2), dtype=torch.bfloat16),
        "nested": [torch.ones(2, dtype=torch.bool), (np.int32(7), "x", None)],
    }
    got = decode_payload(json.loads(json.dumps(encode_payload(payload))))
    np.testing.assert_array_equal(got["f32"], payload["f32"])
    assert got["f32"].dtype == np.float32
    assert got["f64_be"].tobytes() == payload["f64_be"].astype("<f8").tobytes()
    np.testing.assert_array_equal(got["i64"], payload["i64"])
    assert got["scalar"] == float(np.float32(0.1))
    assert got["t_f32"].tobytes() == payload["t_f32"].numpy().tobytes()
    assert got["t_i32"].dtype == np.int32 and got["t_i32"].shape == (2, 5)
    assert np.float32(got["t_0d"]) == payload["t_0d"].item()
    # bf16 has no numpy dtype: it comes back as a torch bf16 tensor, same bits
    assert isinstance(got["t_bf16"], torch.Tensor) and got["t_bf16"].dtype == torch.bfloat16
    assert torch.equal(got["t_bf16"].view(torch.int16), bf.view(torch.int16))
    assert got["t_bf16_empty"].shape == (0, 2)
    assert got["nested"][0].dtype == np.bool_ and got["nested"][1] == [7, "x", None]


# -- the launcher and the imports ---------------------------------------------


def test_launcher_builds_a_cpu_server_with_the_standard_datasets():
    srv = launch_serve.build_server(device="cpu", max_batch=4)
    assert sorted(srv.datasets) == ["edges", "lines", "points"]
    with srv:
        health = BlazeClient(srv.url).health()
        assert health["ok"] and health["datasets"] == ["edges", "lines", "points"]
        r, meta = BlazeClient(srv.url).query("knn", {"k": 3, "query": [0.0] * 4})
        assert r["neighbors"].shape == (3, 4) and meta["cache"] == "compile"


def test_launcher_forwards_arch_to_serve_lm(capsys):
    launch_serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                       "--batch", "1", "--prompt-len", "4", "--gen", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["generated_shape"] == [1, 2]


def test_serve_imports_neither_jax_nor_repro():
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    code = (
        "import sys, repro_torch.serve, repro_torch.launch.serve\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(repro_torch.serve.__all__), bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": src})
    assert out.stdout.split() == ["24", "[]"], out.stdout
