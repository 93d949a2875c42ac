"""The port's ("node", "data") topology across processes, on the CPU.

Each topology is ``P`` real processes over ``gloo``
(``launch.simulate.spawn_local``), one node row a process: (2 x 4) and
(4 x 2), the 8 shards of ``tests/test_torch_multihost.py`` at its sizes.
Every rank runs the same job matrix (``_jobs``): the six drivers per op and
as programs, fig. 6's hand-fused step, the exactness law's integer rows
with sum/min/max and a custom product, dense sums with wire none/bf16/int8,
hierarchical and flat, per op and as programs (int8 with its residual
carried), the naive engine, hash targets with every engine, overflow
escalation, tuning, and a ``collective.inter`` fault armed on every rank.

Held three ways:

* every rank's result is the same, bit for bit;
* each equals the in-process mesh of the same shape
  (``make_node_data_mesh(P, n_shards=8, device="cpu")`` in this process),
  bit for bit: a reduce gathers exactly the partials the in-process code
  folds and every rank folds them alike (``core.collectives``);
* each is held against JAX's ``(P x 8/P)`` mesh on 8 forced CPU devices
  (one subprocess) with the tolerances ``tests/test_torch_multihost.py``
  and ``tests/test_torch_algorithms.py`` use: integer sums, counts, min,
  max and kNN's rows exact; PageRank 1e-4 of the largest score; k-means
  centres 1e-4; GMM 1e-5 relative on the log-likelihood and 1e-4 on the
  parameters.

Hash targets are compared as dicts, the ranks' local tables' union and the
sum of their overflow counters too.  A rank that raises, or that never
returns, fails its spawn with its stderr inside the timeout.
"""
from __future__ import annotations

import collections
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import make_node_data_mesh
from repro_torch.launch.simulate import local_env, spawn_local

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPOLOGIES = (2, 4)  # processes, one node row each, of the 8 shards

_DATA = """
import numpy as np
from repro.data.synthetic import cluster_points, rmat_edges
DATA = dict(
    ints=np.random.RandomState(0).randint(-50, 50, (64, 4)).astype(np.float32),
    floats=np.random.RandomState(1).randn(64, 8).astype(np.float32),
    pos=np.random.RandomState(5).uniform(0.5, 1.5, (64, 4)).astype(np.float32),
    words=np.random.RandomState(0).randint(0, 100, 5000).astype(np.int32),
    edges=rmat_edges(7, 8, seed=2),
    pts=cluster_points(2000, 3, 4, seed=0)[0],
    gpts=cluster_points(803, 2, 3, seed=4)[0],
    kpts=cluster_points(4001, 4, 3, seed=9)[0],
)
"""
_ns: dict = {}
exec(_DATA, _ns)
DATA = _ns["DATA"]

# JAX's (P x 8/P) mesh on 8 forced CPU devices, the jobs it shares with the port.
_JAX = _DATA + """
import json
import jax, jax.numpy as jnp
from repro.core import BlazeSession
from repro.core.algorithms import estimate_pi, gmm_em, kmeans, knn, pagerank, wordcount
from repro.launch.mesh import make_node_data_mesh
assert len(jax.devices()) == 8

def _row(i, r, emit):
    emit(0, r)

out = {}
for n in (2, 4):
    mesh = make_node_data_mesh(n)
    s = BlazeSession(mesh=mesh)
    res = {}
    v = s.distribute(DATA["ints"])
    for red in ("sum", "min", "max"):
        fill = {"sum": 0.0, "min": np.inf, "max": -np.inf}[red]
        for hier in (True, False):
            got = s.map_reduce(v, _row, red, jnp.full((1, 4), fill, jnp.float32),
                               hierarchical=hier)
            res[f"law/{red}/{hier}"] = np.asarray(got).tolist()
    res["pr"] = np.asarray(pagerank(DATA["edges"], 128, tol=0.0, max_iters=10,
                                    session=s).scores).tolist()
    res["pr_program"] = np.asarray(pagerank(DATA["edges"], 128, tol=0.0, max_iters=10,
                                            session=s, mode="program", unroll=5).scores).tolist()
    pts = DATA["pts"]
    res["km"] = np.asarray(kmeans(pts, 4, init_centers=pts[:4].copy(), tol=0.0, max_iters=10,
                                  session=s).centers).tolist()
    res["km_program"] = np.asarray(kmeans(pts, 4, init_centers=pts[:4].copy(), tol=0.0,
                                          max_iters=10, session=s, mode="program",
                                          unroll=5).centers).tolist()
    hm = wordcount(DATA["words"].reshape(-1, 8), session=s)
    res["wc"] = {str(k): int(c) for k, c in hm.to_dict().items()}
    g = gmm_em(DATA["gpts"], 3, init_mu=DATA["gpts"][:3].copy(), tol=0.0, max_iters=5,
               session=s)
    res["gmm"] = {"ll": float(g.log_likelihood), "alpha": np.asarray(g.alpha).tolist(),
                  "mu": np.asarray(g.mu).tolist(), "sigma": np.asarray(g.sigma).tolist()}
    res["knn"] = np.asarray(knn(DATA["kpts"], np.zeros(4, np.float32), 64,
                                session=s).neighbors).tolist()
    res["pi"] = float(estimate_pi(100_000, session=s))
    out[str(n)] = res
print(json.dumps(out))
"""


# -- the job matrix, run alike in every rank and in this process ---------------


def _row(i, r, emit):
    emit(0, r)


def _tok(i, w, emit):
    emit(w, 1)


def _fill(red):
    return {"sum": 0.0, "min": float("inf"), "max": float("-inf"), "prod": 1.0}[red]


def _counts(hm) -> dict:
    return {int(k): int(v) for k, v in hm.to_dict().items()}


def _jobs(mesh, D) -> dict:
    """Every job of the matrix on ``mesh``; results as host values.  Keys
    under ``local/`` are this rank's own rows (they differ between ranks);
    under ``timed/``, choices made from wall times (rank 0's on every rank,
    but another run's in this process)."""
    from repro_torch.core import BlazeSession, custom_reducer, faults
    from repro_torch.core.algorithms import (
        estimate_pi, gmm_em, kmeans, knn, pagerank, wordcount)
    from repro_torch.core.collectives import gather_rows
    from repro_torch.core.mapreduce import make_collectives
    from repro_torch.core.reducers import get_reducer
    from repro_torch.distributed.collectives import compressed_psum
    from repro_torch.kernels import ops

    out = {}
    s = BlazeSession(mesh=mesh)
    prod = custom_reducer("prod_custom", lambda a, b: a * b,
                          lambda dt: torch.ones((), dtype=dt))

    # the exactness law (integer-valued sums, min, max) and custom products
    v = s.distribute(D["ints"])
    for red in ("sum", "min", "max"):
        for hier in (True, False):
            out[f"law/{red}/{hier}"] = s.map_reduce(
                v, _row, red, torch.full((1, 4), _fill(red)), hierarchical=hier).numpy()
    pv = s.distribute(D["pos"])
    for red in ("prod", prod):
        for hier in (True, False):
            name = red if isinstance(red, str) else red.name
            out[f"prod/{name}/{hier}"] = s.map_reduce(
                pv, _row, red, torch.ones(1, 4), hierarchical=hier).numpy()

    # dense float sums with every wire, hierarchical and flat, per op (with
    # the statistics) and as programs (int8: the residual carried)
    fv = s.distribute(D["floats"])
    for wire in ("none", "bf16", "int8"):
        for hier in (True, False):
            got, st = s.map_reduce(fv, _row, "sum", torch.zeros(1, 8), wire=wire,
                                   hierarchical=hier, return_stats=True)
            st = st.finalize()
            out[f"wire/{wire}/{hier}"] = got.numpy()
            out[f"wire/{wire}/{hier}/stats"] = (st.collective, st.intra_bytes, st.inter_bytes,
                                                st.pairs_emitted, st.shuffle_payload_bytes)

            def step(ctx, state, wire=wire):
                t = ctx.map_reduce(fv, _row, "sum", torch.zeros(1, 8), wire=wire)
                return {"acc": state["acc"] + t[0]}

            prog = s.program(step, hierarchical=hier)
            out[f"wire_program/{wire}/{hier}"] = prog({"acc": torch.zeros(8)}, 3)["acc"].numpy()
            out[f"wire_program/{wire}/{hier}/plan"] = (prog.plan.hash,
                                                       prog.plan.collectives_per_iter)
    # the wires' sums themselves, over the shards' rows this process holds
    x = torch.from_numpy(D["floats"]).reshape(8, 64)
    gather = None
    if mesh.process:
        x = x[mesh.rank * mesh.n_local:(mesh.rank + 1) * mesh.n_local]
        gather = functools.partial(gather_rows, mesh)
    for wire in ("none", "bf16", "int8"):
        out[f"psum/{wire}"] = compressed_psum(x, wire=wire, gather=gather).numpy()
    coll = make_collectives(mesh)
    for hier in (True, False):
        red, res = coll.reduce_feedback(x, get_reducer("sum"), "int8", torch.zeros_like(x),
                                        hier=hier)
        out[f"psum/feedback/{hier}"] = (red.numpy(), (gather or (lambda t: t))(res).numpy())

    got, st = s.map_reduce(v, _row, "sum", torch.zeros(1, 4), engine="naive",
                           return_stats=True)
    st = st.finalize()
    out["naive"] = (got.numpy(), st.pairs_emitted, st.shuffle_payload_bytes, st.collective)

    # the six drivers, per op and as programs
    edges, pts = D["edges"], D["pts"]
    for wire in ("none", "bf16", "int8"):
        pr = pagerank(edges, 128, tol=0.0, max_iters=10, wire=wire, session=s)
        out[f"pagerank/{wire}"] = (pr.scores, pr.shuffle_bytes_per_iter,
                                   pr.pairs_shipped_per_iter)
        out[f"pagerank_program/{wire}"] = pagerank(
            edges, 128, tol=0.0, max_iters=10, wire=wire, session=s, mode="program",
            unroll=5).scores
    pr = pagerank(edges, 128, tol=0.0, max_iters=10, engine="pallas", session=s,
                  mode="program", unroll=5)
    out["pagerank_program/pallas"] = (pr.scores, pr.program_compiles, pr.dispatches,
                                      pr.collectives_per_iter)
    for mode in ("per_op", "program"):
        for wire in ("none", "int8"):
            km = kmeans(pts, 4, init_centers=pts[:4].copy(), tol=0.0, max_iters=10,
                        wire=wire, session=s, mode=mode, unroll=5)
            out[f"kmeans/{mode}/{wire}"] = (km.centers, km.inertia, km.iterations)
    km = kmeans(pts, 4, tol=0.0, max_iters=5, seed=3, engine="pallas", session=s)
    out["kmeans/drawn_centres"] = (km.centers, km.inertia)  # init drawn from the data
    for mode in ("per_op", "program"):
        g = gmm_em(D["gpts"], 3, init_mu=D["gpts"][:3].copy(), tol=0.0, max_iters=5,
                   session=s, mode=mode, unroll=5)
        out[f"gmm/{mode}"] = (g.alpha, g.mu, g.sigma, g.log_likelihood)
    g = gmm_em(D["gpts"], 3, init_mu=D["gpts"][:3].copy(), tol=0.0, max_iters=3,
               engine="pallas", session=s)
    out["gmm/pallas"] = (g.mu, g.log_likelihood)
    for mode in ("per_op", "program"):
        nn = knn(D["kpts"], np.zeros(4, np.float32), 64, session=s, mode=mode)
        out[f"knn/{mode}"] = (nn.neighbors, nn.distances, nn.wire_candidates)
    out["pi/per_op"] = estimate_pi(100_000, session=s)
    out["pi/program"] = estimate_pi(100_000, session=s, mode="program")
    lines = D["words"].reshape(-1, 8)
    for engine in ("eager", "pallas", "naive"):
        hm, st = wordcount(lines, engine=engine, return_stats=True, session=s)
        st = st.finalize()
        out[f"wordcount/{engine}"] = (_counts(hm), hm.total_overflow(), hm.size(),
                                      st.pairs_emitted, st.pairs_shipped,
                                      st.shuffle_payload_bytes, st.intra_bytes,
                                      st.inter_bytes)
        t = hm.table
        live = (t.keys != -(2 ** 31)).numpy()
        out[f"local/wordcount/{engine}"] = (
            dict(zip(t.keys.numpy()[live].tolist(), t.vals.numpy()[live].tolist())),
            int(t.overflow.sum()))
    out["wordcount/dense"] = wordcount(lines, target="dense", session=s).numpy()
    res = wordcount(lines, engine="pallas", mode="program", iters=3, unroll=2, session=s)
    out["wordcount/program"] = (_counts(res.counts), res.counts.total_overflow(),
                                res.program_compiles, res.dispatches)

    # fig. 6's hand-fused step: each shard's K3 partial, reduced over the mesh
    pts_v = s.distribute(pts)
    coll, total = make_collectives(mesh), get_reducer("sum")
    for hier in (True, False):
        def fig6(ctx, st, hier=hier):
            data = pts_v.data
            per = data.shape[0] // mesh.n_local
            parts = torch.stack([ops.kmeans_assign(data[i * per:(i + 1) * per], st["c"])[1]
                                 for i in range(mesh.n_local)])
            sums = coll.reduce(parts, total, hier=hier)
            return {"c": sums[:, :3] / torch.clamp(sums[:, 3:], min=1.0)}

        c, _ = s.run_loop(s.program(fig6), {"c": torch.from_numpy(pts[:4].copy())},
                          max_iters=5, unroll=5)
        out[f"fig6/{hier}"] = c["c"].numpy()

    # escalation reads the mesh's overflow: every rank regrows alike
    es = BlazeSession(mesh=mesh, escalate_overflow=True)
    hm = es.make_dist_hashmap(8, (), torch.int32, "sum")
    hm, st = es.map_reduce(es.distribute(D["words"]), _tok, "sum", hm, return_stats=True)
    out["escalate"] = (_counts(hm), hm.total_overflow(), st.escalations,
                       hm.capacity_per_shard)
    # tuning: the ranks time their candidates apart, and take rank 0's winner
    ts = BlazeSession(mesh=mesh)
    ts.map_reduce(v, _tok_dense, "sum", torch.zeros(64, dtype=torch.int32), tune=True)
    out["timed/tuned"] = sorted((k, c.describe()) for k, c in ts.tuning._entries.items())

    # a collective.inter fault armed alike on every rank, retried
    faults.reset(env=False)
    try:
        fs = BlazeSession(mesh=mesh, retry=faults.RetryPolicy(
            attempts=3, backoff_s=0.0, multiplier=1.0, deadline_s=None))
        faults.configure("collective.inter", at=1)
        got = fs.map_reduce(fs.distribute(D["ints"]), _row, "sum", torch.zeros(1, 4))
        snap = faults.snapshot()
        out["fault"] = (got.numpy(), fs.stats.retries, snap["balanced"],
                        snap["dispositions"]["retried"])
        # a kernel fault armed alike on every rank degrades every rank's node
        faults.reset(env=False)
        faults.configure("kernel.segment", at=1)
        got, st = fs.map_reduce(v, _row_by_index, "sum", torch.zeros(4, 4), engine="pallas",
                                return_stats=True)
        snap = faults.snapshot()
        eager = fs.map_reduce(v, _row_by_index, "sum", torch.zeros(4, 4), engine="eager")
        out["degrade"] = (got.numpy(), eager.numpy(), st.degraded_engine,
                          fs.stats.degraded_nodes, snap["dispositions"]["degraded"])
    finally:
        faults.reset(env=False)
    return out


def _row_by_index(i, r, emit):
    emit(i % 4, r)


def _tok_dense(i, r, emit):
    emit((r[0].to(torch.int32) + 50) % 64, 1)


def _rank_jobs(rank, n_procs, data):
    return _jobs(make_node_data_mesh(n_procs, n_shards=8, device="cpu"), data)


# -- fixtures -------------------------------------------------------------------


@pytest.fixture(scope="module", params=TOPOLOGIES, ids=lambda p: f"{p}x{8 // p}")
def topo(request):
    """``(P, the ranks' results, the in-process mesh's results)``."""
    n = request.param
    ranks = spawn_local(n, _rank_jobs, n, DATA, timeout=240)
    local = _jobs(make_node_data_mesh(n, n_shards=8, device="cpu"), DATA)
    return n, ranks, local


@pytest.fixture(scope="module")
def jax8():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("BLAZE_FAULTS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX], capture_output=True, text=True,
                          env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _same(a, b) -> bool:
    """Bit-for-bit equality of nested host results."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b


# -- the tests ------------------------------------------------------------------


def test_every_rank_holds_the_same_bits(topo):
    n, ranks, _ = topo
    assert len(ranks) == n
    for key, want in ranks[0].items():
        if key.startswith("local/"):
            continue
        for r, res in enumerate(ranks[1:], 1):
            assert _same(res[key], want), f"rank {r} differs from rank 0 on {key}"


def test_processes_match_the_in_process_mesh_bit_for_bit(topo):
    _, ranks, local = topo
    assert ranks[0].keys() == local.keys()
    for key, want in local.items():
        if key.startswith(("local/", "timed/")):
            continue
        assert _same(ranks[0][key], want), key


def test_hash_tables_split_between_ranks(topo):
    """Each rank's local tables hold its shards' keys: the union over ranks
    is the whole map, no key on two ranks, and the overflow summed over the
    ranks is the map's."""
    n, ranks, local = topo
    ref = dict(collections.Counter(DATA["words"].tolist()))
    for engine in ("eager", "pallas", "naive"):
        union, overflow = {}, 0
        for res in ranks:
            part, ovf = res[f"local/wordcount/{engine}"]
            assert not union.keys() & part.keys()
            union.update(part)
            overflow += ovf
        counts, total_ovf, size = ranks[0][f"wordcount/{engine}"][:3]
        assert union == counts == ref and size == len(ref)
        assert overflow == total_ovf == local[f"wordcount/{engine}"][1] == 0
    counts, ovf, escal, cap = ranks[0]["escalate"]
    # the re-run's target carries the original's counters: no pair dropped
    assert counts == ref and ovf == 0 and escal >= 1 and cap > 8
    assert ranks[0]["wordcount/program"][:2] == ({k: 3 * c for k, c in ref.items()}, 0)
    assert np.array_equal(ranks[0]["wordcount/dense"],
                          np.bincount(DATA["words"], minlength=100).astype(np.int32))


def test_integer_sums_and_the_fault_retry(topo):
    """The law: integer-valued sums, min and max are the NumPy oracle's,
    hierarchical and flat; a collective.inter fault armed on every rank is
    retried once on each and gives the fault-free bits."""
    _, ranks, _ = topo
    res = ranks[0]
    vals = DATA["ints"]
    for red, want in (("sum", vals.sum(0)), ("min", vals.min(0)), ("max", vals.max(0))):
        for hier in (True, False):
            assert np.array_equal(res[f"law/{red}/{hier}"][0], want)
    got, retries, balanced, retried = res["fault"]
    assert _same(got, res["law/sum/True"]) and (retries, balanced, retried) == (1, True, 1)
    got, eager, engine, degraded, disposed = res["degrade"]
    assert _same(got, eager) and (engine, degraded, disposed) == ("pallas", 1, 1)
    assert np.array_equal(got, vals.reshape(-1, 4, 4).sum(0))
    for name in ("prod", "prod_custom"):
        for hier in (True, False):
            np.testing.assert_allclose(res[f"prod/{name}/{hier}"][0],
                                       np.prod(DATA["pos"].astype(np.float64), 0), rtol=1e-5)
    assert res["timed/tuned"] and all(_same(r["timed/tuned"], res["timed/tuned"])
                                      for r in ranks)


def test_hierarchical_stats_name_the_two_hops(topo):
    n, ranks, _ = topo
    res = ranks[0]
    for wire in ("none", "bf16", "int8"):
        coll_h, _, inter_h, emitted, _ = res[f"wire/{wire}/True/stats"]
        coll_f, intra_f, _, _, _ = res[f"wire/{wire}/False/stats"]
        assert "hier" in coll_h and "hier" not in coll_f and intra_f == 0
        assert emitted == 64  # every rank's rows counted
        assert res[f"wire_program/{wire}/True/plan"][1] == 1
    assert res["naive"][1] == 64


def test_processes_match_jax_8dev(jax8, topo):
    n, ranks, _ = topo
    res, want = ranks[0], jax8[str(n)]
    for red in ("sum", "min", "max"):
        for hier in (True, False):
            assert np.array_equal(res[f"law/{red}/{hier}"],
                                  np.asarray(want[f"law/{red}/{hier}"], np.float32))
    for got, key in ((res["pagerank/none"][0], "pr"),
                     (res["pagerank_program/none"], "pr_program")):
        jscores = np.asarray(want[key])
        assert float(np.abs(got - jscores).max() / jscores.max()) < 1e-4
    np.testing.assert_allclose(res["kmeans/per_op/none"][0], np.asarray(want["km"]), atol=1e-4)
    np.testing.assert_allclose(res["kmeans/program/none"][0], np.asarray(want["km_program"]),
                               atol=1e-4)
    assert res["wordcount/eager"][0] == {int(k): c for k, c in want["wc"].items()}
    alpha, mu, sigma, ll = res["gmm/per_op"]
    jg = want["gmm"]
    assert abs(ll - jg["ll"]) <= 1e-5 * abs(jg["ll"])
    for name, got in (("alpha", alpha), ("mu", mu), ("sigma", sigma)):
        np.testing.assert_allclose(got, jg[name], atol=1e-4, rtol=0, err_msg=name)
    np.testing.assert_array_equal(res["knn/per_op"][0], np.asarray(want["knn"], np.float32))
    np.testing.assert_array_equal(res["knn/program"][0], np.asarray(want["knn"], np.float32))
    assert res["pi/per_op"] == res["pi/program"] == want["pi"]


def _one_rank_jobs(rank, data):
    """The smoke's process phase on the CPU: a group of one process, the
    (1 x 8) mesh that carries it."""
    from repro_torch.core.algorithms import kmeans, pagerank, wordcount

    mesh = make_node_data_mesh(n_shards=8, device="cpu")
    assert mesh.process and (mesh.n_nodes, mesh.n_local, mesh.n_ranks) == (1, 8, 1)
    return _small_jobs(mesh, data, kmeans, pagerank, wordcount)


def _small_jobs(mesh, data, kmeans, pagerank, wordcount):
    from repro_torch.core import BlazeSession

    s = BlazeSession(mesh=mesh)
    pts = data["pts"]
    return {
        "pagerank": pagerank(data["edges"], 128, tol=0.0, max_iters=10, engine="pallas",
                             session=s).scores,
        "pagerank_int8_program": pagerank(data["edges"], 128, tol=0.0, max_iters=10,
                                          wire="int8", mode="program", unroll=5,
                                          session=s).scores,
        "kmeans_program": kmeans(pts, 4, init_centers=pts[:4].copy(), tol=0.0, max_iters=5,
                                 mode="program", unroll=5, session=s).centers,
        "wordcount": _counts(wordcount(data["words"].reshape(-1, 8), engine="pallas",
                                       session=s)),
    }


def test_one_process_group_is_the_in_process_mesh():
    from repro_torch.core.algorithms import kmeans, pagerank, wordcount

    (got,) = spawn_local(1, _one_rank_jobs, DATA, timeout=120)
    want = _small_jobs(make_node_data_mesh(1, n_shards=8, device="cpu"), DATA, kmeans,
                       pagerank, wordcount)
    assert got.keys() == want.keys()
    for key in want:
        assert _same(got[key], want[key]), key


def _global_rows_refused(rank, data):
    """Containers of the global rows (made without the mesh) on a 2-process
    mesh: every entry point refuses them rather than take them for this
    rank's shards; the same data made on the mesh runs."""
    from repro_torch.core import BlazeSession, DistVector
    from repro_torch.core import containers as C
    from repro_torch.core.algorithms import kmeans

    mesh = make_node_data_mesh(2, n_shards=8, device="cpu")
    s = BlazeSession(mesh=mesh)
    x, pts = data["ints"], data["pts"]
    glob = C.distribute(x, 8, "cpu")  # every row, in every rank

    def step(ctx, st):
        return {"a": st["a"] + ctx.map_reduce(glob, _row, "sum", torch.zeros(1, 4))}

    cases = {
        "DistVector": lambda: s.map_reduce(DistVector(torch.from_numpy(x), len(x)), _row,
                                           "sum", torch.zeros(1, 4)),
        "distribute": lambda: s.map_reduce(glob, _row, "sum", torch.zeros(1, 4)),
        "program": lambda: s.program(step)({"a": torch.zeros(1, 4)}),
        "kmeans": lambda: kmeans(C.distribute(pts, 8, "cpu"), 4, init_centers=pts[:4].copy(),
                                 max_iters=1, session=s),
        "topk": lambda: s.topk(C.distribute(x[:, 0], 8, "cpu"), 3),
        "hash target": lambda: s.map_reduce(
            s.distribute(data["words"]), _tok, "sum",
            C.make_dist_hashmap(16, (), torch.int32, "sum", n_shards=8, device="cpu")),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    out["on the mesh"] = s.map_reduce(s.distribute(x), _row, "sum", torch.zeros(1, 4)).numpy()
    return out


def test_containers_of_the_global_rows_are_refused():
    for res in spawn_local(2, _global_rows_refused, DATA, timeout=120):
        for name, msg in res.items():
            if name == "on the mesh":
                assert np.array_equal(msg[0], DATA["ints"].sum(0))
            else:
                assert msg is not None and "not this rank's" in msg, name


def _fail_on_rank_1(rank):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 gives up before the collective")
    dist.barrier()  # rank 0 waits here for a peer that never comes


def _hang_on_rank_1(rank):
    if rank == 1:
        time.sleep(3600)
    return rank


def test_a_failing_rank_fails_the_spawn_with_its_stderr():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        spawn_local(2, _fail_on_rank_1, timeout=60)
    assert "rank 1 gives up before the collective" in str(err.value)
    assert time.monotonic() - t0 < 60
    # rank 0 returns at once, unless a loaded machine is still starting it
    with pytest.raises(RuntimeError, match=r"ranks \[(0, )?1\] of 2 still ran after 8 s"):
        spawn_local(2, _hang_on_rank_1, timeout=8)


def test_local_env_is_the_torchrun_recipe():
    env = local_env(1, 4, base_env={"PATH": "/bin"})
    assert env == {"PATH": "/bin", "RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1"}
    with pytest.raises(ValueError):
        local_env(4, 4)
