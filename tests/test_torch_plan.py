"""The port's logical plans (``repro_torch.core.plan``) against the JAX
package's, mirroring ``tests/test_plan.py``: per-node engine resolution,
plan-hash agreement between the per-op and program paths, collective
batching (GMM's 4 collectives a round → 2), CSE, dead-source pruning, the
EXPLAIN goldens of ``tests/goldens/`` (read, never written), and π/kNN
through the planner with their host syncs counted.

Tolerances: sums of small integer-valued or f32 rows within ``rtol=1e-5``
(order only); the GMM and PageRank jobs within the reference test's own
tolerances; batched and unbatched plans bit-equal (the shard sum is
elementwise); EXPLAIN line for line, with two kinds of line masked: the
header (its plan hash digests the mappers' module paths, which differ
between the packages) and each node's ``cost~N`` field (the port's cost
model may be re-based on the card's own measurements).
"""
import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlazeSession as JaxSession
from repro.core import distribute as jdistribute
from repro.core.algorithms import gmm_em_reference, knn_full_sort, pagerank_reference
from repro.data.synthetic import cluster_points, rmat_edges
from repro_torch.core import BlazeSession, DistRange
from repro_torch.core.algorithms import estimate_pi, gmm_em, kmeans, knn, pagerank

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
_ALG = "repro_torch.core.algorithms."


def _cpu(n_shards=1):
    return BlazeSession(device="cpu", n_shards=n_shards)


def _dyn_mapper(i, x, emit):
    emit(x[0].to(torch.int32) % 8, x[1])


def _dyn4_mapper(i, x, emit):
    emit(x[0].to(torch.int32) % 4, x[1] * 2.0)


def _rows(n=64, seed=0):
    rows = np.random.RandomState(seed).randn(n, 2).astype(np.float32)
    rows[:, 0] = np.random.RandomState(seed + 1).randint(0, 8, n)
    return rows


def _sum_oracle(rows, kmod=8, scale=1.0):
    out = np.zeros(kmod)
    for r in rows:
        out[int(np.int32(r[0])) % kmod] += r[1] * scale
    return out


# -- plan hashes: the per-op and program paths agree ---------------------------


def test_per_op_and_program_plan_hashes_agree_for_pi():
    from repro_torch.core.algorithms.pi import _program_step, pi_mapper

    sess = _cpu()
    _, st = sess.map_reduce(DistRange(0, 10_000, 1), pi_mapper, "sum",
                            torch.zeros(1, dtype=torch.int32), return_stats=True)
    assert st.plan_hash is not None
    step, state = _program_step(10_000, "eager", sess.device)
    (node,) = sess.program(step).build(state).mapreduce_nodes()
    assert node.hash == st.plan_hash


def test_per_op_and_program_plan_hashes_agree_for_hash_targets():
    from repro_torch.core.algorithms.wordcount import _program_step, wordcount_mapper

    sess = _cpu()
    lines = np.random.RandomState(0).randint(0, 50, (32, 8)).astype(np.int32)
    lv = sess.distribute(lines)
    hm = sess.make_dist_hashmap(256, (), torch.int32, "sum")
    _, st = sess.map_reduce(lv, wordcount_mapper, "sum", hm, key_range=50,
                            return_stats=True)
    step, state = _program_step(lv, hm, 50, "eager")
    (node,) = sess.program(step).build(state).mapreduce_nodes()
    assert node.hash == st.plan_hash


def test_plan_hash_distinguishes_engine_wire_and_mapper():
    from repro_torch.core.algorithms.pi import pi_mapper

    def other_mapper(v, emit):
        emit(0, torch.where(v % 2 == 0, 1, 0))

    sess = _cpu()
    src = DistRange(0, 1000, 1)
    t = torch.zeros(1, dtype=torch.int32)
    _, a = sess.map_reduce(src, pi_mapper, "sum", t, return_stats=True)
    _, b = sess.map_reduce(src, pi_mapper, "sum", t, engine="naive", return_stats=True)
    _, c = sess.map_reduce(src, other_mapper, "sum", t, return_stats=True)
    _, d = sess.map_reduce(src, pi_mapper, "sum", t, wire="bf16", return_stats=True)
    assert len({a.plan_hash, b.plan_hash, c.plan_hash, d.plan_hash}) == 4


def test_resolve_engine_importable_from_plan_and_session():
    from repro_torch.core.cost import PALLAS_AUTO_MAX_KEYS as P0
    from repro_torch.core.plan import resolve_engine as r1
    from repro_torch.core.session import PALLAS_AUTO_MAX_KEYS as P2, resolve_engine as r2

    assert r1 is r2 and P0 == P2


# -- collective batching -------------------------------------------------------


def test_independent_sums_batch_into_one_collective():
    sess = _cpu()
    rows = _rows()
    pts = sess.distribute(rows)

    def step(ctx, s):
        a = ctx.map_reduce(pts, _dyn_mapper, "sum", torch.zeros(8))
        b = ctx.map_reduce(pts, _dyn4_mapper, "sum", torch.zeros(4))
        return {"a": a + 0, "b": b + 0}  # first consumption after both ops

    prog = sess.program(step)
    state = {"a": torch.zeros(8), "b": torch.zeros(4)}
    plan = prog.build(state)
    assert plan.collectives_per_iter == 1 and plan.collectives_unbatched == 2
    assert len(plan.groups) == 1 and sorted(plan.groups[0]) == [0, 1]
    out = prog(state, 1)
    np.testing.assert_allclose(out["a"].numpy(), _sum_oracle(rows), rtol=1e-5)
    np.testing.assert_allclose(out["b"].numpy(), _sum_oracle(rows, 4, 2.0), rtol=1e-5)


def test_batching_respects_reducer_and_dtype_boundaries():
    """sum f32, sum i32 and max f32 partials cannot share a collective."""
    sess = _cpu()
    rows = _rows()
    pts = sess.distribute(rows)

    def int_mapper(i, x, emit):
        emit(x[0].to(torch.int32) % 4, 1)

    def step(ctx, s):
        a = ctx.map_reduce(pts, _dyn_mapper, "sum", torch.zeros(8))
        b = ctx.map_reduce(pts, int_mapper, "sum", torch.zeros(4, dtype=torch.int32))
        c = ctx.map_reduce(pts, _dyn_mapper, "max", torch.full((8,), float("-inf")))
        return {"a": a + 0, "b": b + 0, "c": c + 0}

    prog = sess.program(step)
    state = {"a": torch.zeros(8), "b": torch.zeros(4, dtype=torch.int32),
             "c": torch.zeros(8)}
    plan = prog.build(state)
    assert plan.collectives_per_iter == 3 and not plan.groups
    out = prog(state, 1)
    np.testing.assert_allclose(out["a"].numpy(), _sum_oracle(rows), rtol=1e-5)
    counts = np.zeros(4)
    mx = np.full(8, -np.inf)
    for r in rows:
        counts[int(np.int32(r[0])) % 4] += 1
        k = int(np.int32(r[0])) % 8
        mx[k] = max(mx[k], r[1])
    np.testing.assert_array_equal(out["b"].numpy(), counts)
    np.testing.assert_allclose(out["c"].numpy(), mx, rtol=1e-6)


@pytest.mark.parametrize("engine", ("eager", "pallas", "naive"))
def test_gmm_program_issues_fewer_collectives_and_stays_exact(engine):
    """GMM's EM round: ll/N_k/Σwx batch into one collective, Σw(x−μ)(x−μ)ᵀ
    ships alone (2, against JAX's 2); naive ops are not batchable.  The
    reference test's tolerances against the float64 EM."""
    pts, _ = cluster_points(600, 2, 3, seed=1)
    init = pts[:3].copy()
    res = gmm_em(pts, 3, init_mu=init, tol=0.0, max_iters=10, engine=engine,
                 session=_cpu(), mode="program", unroll=5)
    if engine in ("eager", "pallas"):
        assert res.collectives_per_iter == 2
    else:
        assert res.collectives_per_iter > 2
    ra, rm, rs, rll, _ = gmm_em_reference(pts, 3, init, tol=0.0, max_iters=10)
    assert float(np.abs(res.mu - rm).max()) < 1e-2
    assert float(np.abs(res.alpha - ra).max()) < 1e-3
    assert abs(res.log_likelihood - rll) / abs(rll) < 1e-3


def test_gmm_batched_vs_unoptimized_plans_agree_exactly():
    """passes=() switches the optimiser off: 4 collectives instead of 2, and
    bit-equal results (a concatenated shard sum == separate ones)."""
    from repro_torch.core.algorithms.gmm import _program_step

    pts, _ = cluster_points(400, 2, 3, seed=2)
    rows0 = np.concatenate([pts, np.zeros((400, 3), np.float32)], axis=1)
    sess = _cpu(2)
    step, state0 = _program_step(sess.distribute(rows0), 3, 2, 400, "eager")
    init = state0(np.full(3, 1 / 3, np.float32), pts[:3].copy(),
                  np.tile(np.eye(2, dtype=np.float32), (3, 1, 1)))
    opt = sess.program(step)
    unopt = sess.program(step, passes=())
    assert opt.build(init).collectives_per_iter == 2
    assert unopt.build(init).collectives_per_iter == 4
    assert unopt.build(init).collectives_unbatched == 4
    a, b = opt(init, 5), unopt(init, 5)
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())


def test_pagerank_program_batches_sink_and_contribution():
    edges = rmat_edges(6, 8, seed=3)
    res = pagerank(edges, 64, tol=0.0, max_iters=10, session=_cpu(),
                   mode="program", unroll=5)
    assert res.collectives_per_iter == 2
    ref = pagerank_reference(edges, 64, tol=0.0, max_iters=10)
    assert float(np.abs(res.scores - ref).max() / ref.max()) < 1e-4


def test_kmeans_program_single_collective_carries_inertia():
    pts, _ = cluster_points(1000, 3, 4, seed=0)
    init = pts[:4].copy()
    res = kmeans(pts, 4, init_centers=init, tol=0.0, max_iters=10, session=_cpu(),
                 mode="program", unroll=5)
    assert res.collectives_per_iter == 1  # sums+counts+inertia in one sum
    assert res.compiles == 0  # no per-op inertia stage
    per_op = kmeans(pts, 4, init_centers=init, tol=0.0, max_iters=10, session=_cpu())
    assert abs(res.inertia - per_op.inertia) <= 1e-4 * abs(per_op.inertia)


def test_collectives_per_iter_equal_jax_plans():
    """GMM, PageRank and k-means: the port's optimised and unoptimised plans
    issue as many collectives an iteration as JAX's, at 1 and 4 shards."""
    ja = {m: importlib.import_module("repro.core.algorithms." + m)
          for m in ("gmm", "pagerank", "kmeans")}
    ta = {m: importlib.import_module(_ALG + m) for m in ("gmm", "pagerank", "kmeans")}
    jsess = JaxSession()
    for n_shards in (1, 4):
        sess = _cpu(n_shards)
        for passes in (None, ()):
            got, want = {}, {}
            rows = np.zeros((256, 5), np.float32)
            step, state0 = ta["gmm"]._program_step(sess.distribute(rows), 3, 2, 256, "eager")
            init = (np.full(3, 1 / 3, np.float32), np.zeros((3, 2), np.float32),
                    np.tile(np.eye(2, dtype=np.float32), (3, 1, 1)))
            got["gmm"] = sess.program(step, passes=passes).build(state0(*init))
            jstep, jstate0 = ja["gmm"]._program_step(jdistribute(rows, jsess.mesh), 3, 2,
                                                     256, "eager")
            want["gmm"] = jsess.program(jstep, passes=passes).build(jstate0(*init))
            edges = np.zeros((512, 2), np.int32)
            step, state0 = ta["pagerank"]._program_step(
                sess.distribute(edges), torch.zeros(64, dtype=torch.int32), 64, 0.85,
                "eager", "none")
            got["pagerank"] = sess.program(step, passes=passes).build(
                state0(torch.full((64,), 1 / 64)))
            jstep, jstate0 = ja["pagerank"]._program_step(
                jdistribute(edges, jsess.mesh), jnp.zeros(64, jnp.int32), 64, 0.85,
                "eager", "none")
            want["pagerank"] = jsess.program(jstep, passes=passes).build(
                jstate0(jnp.full((64,), 1 / 64, jnp.float32)))
            pts = np.zeros((256, 3), np.float32)
            step, state0 = ta["kmeans"]._program_step(sess.distribute(pts), 4, 3,
                                                      "eager", "none")
            got["kmeans"] = sess.program(step, passes=passes).build(state0(torch.zeros(4, 3)))
            jstep, jstate0 = ja["kmeans"]._program_step(jdistribute(pts, jsess.mesh), 4,
                                                        3, "eager", "none")
            want["kmeans"] = jsess.program(jstep, passes=passes).build(
                jstate0(jnp.zeros((4, 3), jnp.float32)))
            for name in got:
                assert (got[name].collectives_per_iter, got[name].collectives_unbatched) == (
                    want[name].collectives_per_iter, want[name].collectives_unbatched), name
                assert sorted(got[name].groups.values()) == sorted(want[name].groups.values())
    assert got["gmm"].collectives_per_iter == 4  # passes=() last


# -- CSE -----------------------------------------------------------------------


def test_identical_ops_cse_even_with_different_targets():
    """Same (source, mapper, reducer, engine, wire, env): computed once, each
    merged into its own target."""
    sess = _cpu()
    rows = _rows()
    pts = sess.distribute(rows)

    def step(ctx, s):
        a = ctx.map_reduce(pts, _dyn_mapper, "sum", torch.zeros(8))
        b = ctx.map_reduce(pts, _dyn_mapper, "sum", torch.full((8,), 5.0))
        return {"a": a + 0, "b": b + 0}

    prog = sess.program(step)
    state = {"a": torch.zeros(8), "b": torch.zeros(8)}
    plan = prog.build(state)
    assert plan.cse_hits == 1 and plan.collectives_per_iter == 1
    assert plan.mapreduce_nodes()[1].cse_of == 0
    out = prog(state, 1)
    ref = _sum_oracle(rows)
    np.testing.assert_allclose(out["a"].numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(out["b"].numpy(), ref + 5.0, rtol=1e-5)


def test_different_env_values_do_not_cse():
    sess = _cpu()
    rows = _rows()
    pts = sess.distribute(rows)

    def scaled(i, x, emit, env):
        emit(x[0].to(torch.int32) % 8, x[1] * env)

    def step(ctx, s):
        a = ctx.map_reduce(pts, scaled, "sum", torch.zeros(8), env=s["u"])
        b = ctx.map_reduce(pts, scaled, "sum", torch.zeros(8), env=s["u"] * 2.0)
        return {"a": a + 0, "b": b + 0, "u": s["u"]}

    prog = sess.program(step)
    state = {"a": torch.zeros(8), "b": torch.zeros(8), "u": torch.tensor(1.0)}
    assert prog.build(state).cse_hits == 0
    out = prog(state, 1)
    ref = _sum_oracle(rows)
    np.testing.assert_allclose(out["a"].numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(out["b"].numpy(), 2 * ref, rtol=1e-5)


# -- dead-op / dead-source pruning ---------------------------------------------


def test_dead_op_and_its_source_are_pruned():
    """An op whose result is never consumed is dropped, and a source only it
    read is not among the program's live operands."""
    sess = _cpu()
    rows = _rows()
    pts = sess.distribute(rows)
    unused = sess.distribute(np.ones((16, 2), np.float32))

    def step(ctx, s):
        a = ctx.map_reduce(pts, _dyn_mapper, "sum", torch.zeros(8))
        got = a + 0  # flush a before the dead op exists
        _ = ctx.map_reduce(unused, _dyn_mapper, "sum", torch.zeros(8))
        return {"a": got}

    prog = sess.program(step)
    state = {"a": torch.zeros(8)}
    plan = prog.build(state)
    assert plan.dead_ops == 1 and plan.pruned_sources == 1
    assert [s.desc for s in plan.sources if s.pruned] == ["vector float32[16x2] n=16"]
    live = plan.live_sources()
    assert len(live) == 1 and live[0].source is pts
    out = prog(state, 2)
    np.testing.assert_allclose(out["a"].numpy(), _sum_oracle(rows), rtol=1e-5)


def test_pruning_disabled_ships_and_runs_everything():
    sess = _cpu()
    pts = sess.distribute(_rows())
    unused = sess.distribute(np.ones((16, 2), np.float32))

    def step(ctx, s):
        a = ctx.map_reduce(pts, _dyn_mapper, "sum", torch.zeros(8))
        got = a + 0
        _ = ctx.map_reduce(unused, _dyn_mapper, "sum", torch.zeros(8))
        return {"a": got}

    prog = sess.program(step, passes=())
    state = {"a": torch.zeros(8)}
    plan = prog.build(state)
    assert plan.dead_ops == 0 and plan.pruned_sources == 0
    assert len(plan.live_sources()) == 2
    prog(state, 1)


# -- explain -------------------------------------------------------------------


def _port_plans() -> dict[str, str]:
    """The six algorithms' plans, built as ``tools/check_explain_goldens.py``
    builds JAX's (same shapes, one shard)."""
    gmm, kmeans_m, knn_m, pagerank_m, pi, wordcount = (
        importlib.import_module(_ALG + m)
        for m in ("gmm", "kmeans", "knn", "pagerank", "pi", "wordcount"))
    sess = _cpu()
    out = {}
    step, state = pi._program_step(100_000, "eager", sess.device)
    out["pi"] = sess.program(step).build(state).render()
    step, state0 = pagerank_m._program_step(
        sess.distribute(np.zeros((512, 2), np.int32)), torch.zeros(64, dtype=torch.int32),
        64, 0.85, "eager", "none")
    out["pagerank"] = sess.program(step).build(state0(torch.full((64,), 1 / 64))).render()
    step, state0 = kmeans_m._program_step(sess.distribute(np.zeros((256, 3), np.float32)),
                                          4, 3, "eager", "none")
    out["kmeans"] = sess.program(step).build(state0(torch.zeros(4, 3))).render()
    step, state0 = gmm._program_step(sess.distribute(np.zeros((256, 5), np.float32)),
                                     3, 2, 256, "eager")
    out["gmm"] = sess.program(step).build(state0(
        np.full(3, 1 / 3, np.float32), np.zeros((3, 2), np.float32),
        np.tile(np.eye(2, dtype=np.float32), (3, 1, 1)))).render()
    hm = sess.make_dist_hashmap(256, (), torch.int32, "sum")
    step, state = wordcount._program_step(sess.distribute(np.zeros((32, 8), np.int32)),
                                          hm, 50, "pallas")
    out["wordcount"] = sess.program(step).build(state).render()
    step = knn_m._program_step(sess.distribute(np.zeros((256, 3), np.float32)), 8, "pallas")
    out["knn"] = sess.program(step).build({
        "q": torch.zeros(3), "neighbors": torch.zeros(8, 3),
        "scores": torch.full((8,), float("-inf"))}).render()
    return out


def _mask(text: str) -> list[str]:
    """The masked lines: the header's plan hash, each node's cost field."""
    lines = text.splitlines()
    lines[0] = re.sub(r"\(hash [0-9a-f]{12}\)", "(hash MASKED)", lines[0])
    return [re.sub(r" cost~\d+", " cost~MASKED", line) for line in lines]


@pytest.mark.parametrize("name", ("gmm", "kmeans", "knn", "pagerank", "pi", "wordcount"))
def test_explain_golden_snapshots(name):
    """The port's EXPLAIN of each algorithm equals JAX's golden line for line
    outside the masked hash and cost fields."""
    text = _port_plans()[name]
    want = open(os.path.join(GOLDEN_DIR, f"explain_{name}.txt")).read().rstrip("\n")
    assert _mask(text) == _mask(want), text


def test_explain_requires_a_built_plan():
    sess = _cpu()

    def step(ctx, s):
        t = ctx.map_reduce(DistRange(0, 8, 1), lambda v, emit: emit(0, v), "sum",
                           torch.zeros(1, dtype=torch.int32))
        return {"t": t}

    prog = sess.program(step)
    with pytest.raises(ValueError, match="plan"):
        sess.explain(prog)
    text = sess.explain(prog, state={"t": torch.zeros(1, dtype=torch.int32)})
    assert "Blaze logical plan" in text and "map_reduce sum" in text


def test_explain_shows_mixed_engines_per_node():
    sess = _cpu()
    pts = sess.distribute(_rows())

    def step(ctx, s):
        a = ctx.map_reduce(pts, _dyn_mapper, "sum", torch.zeros(8), engine="eager")
        b = ctx.map_reduce(pts, _dyn_mapper, "sum", torch.zeros(8), engine="pallas")
        return {"a": a + 0, "b": b + 0}

    prog = sess.program(step)
    plan = prog.build({"a": torch.zeros(8), "b": torch.zeros(8)})
    assert [n.engine for n in plan.mapreduce_nodes()] == ["eager", "pallas"]
    text = sess.explain(prog)
    assert "engine=eager" in text and "engine=pallas" in text


def test_plan_value_equality_is_elementwise():
    """== / != on a lazy value compare values (forcing the flush), not
    Python identity."""
    sess = _cpu()

    def parity(v, emit):
        emit(v % 2, 1)

    def step(ctx, s):
        c = ctx.map_reduce(DistRange(0, 9, 1), parity, "sum",
                           torch.zeros(2, dtype=torch.int32))
        return {"five": c[0] == 5, "diff": c[0] != c[1]}

    prog = sess.program(step)
    out = prog({"five": torch.tensor(False), "diff": torch.tensor(False)}, 1)
    assert bool(out["five"]) is True and bool(out["diff"]) is True


def test_pi_program_rejects_return_stats():
    with pytest.raises(ValueError, match="per-op"):
        estimate_pi(1000, mode="program", return_stats=True, session=_cpu())


# -- pi / knn through the planner ----------------------------------------------


def test_pi_program_equals_per_op_and_counts_host_syncs():
    sess = _cpu()
    a = estimate_pi(50_000, session=sess)
    assert sess.stats.host_syncs == 1
    b = estimate_pi(50_000, session=sess, mode="program")
    assert a == b
    assert sess.stats.host_syncs == 2 and sess.stats.program_compiles == 1


def test_knn_program_matches_per_op_and_full_sort():
    pts = np.random.RandomState(0).randn(512, 3).astype(np.float32)
    q = np.full(3, 0.5, np.float32)
    sess = _cpu()
    per_op = knn(pts, q, k=16, session=sess)
    assert sess.stats.host_syncs == 1
    prog = knn(pts, q, k=16, session=sess, mode="program")
    ref = knn_full_sort(pts, q, k=16)
    np.testing.assert_allclose(np.sort(per_op.distances), np.sort(ref.distances), rtol=1e-5)
    np.testing.assert_allclose(np.sort(prog.distances), np.sort(ref.distances), rtol=1e-5)
    assert sess.stats.host_syncs == 2


def test_knn_surfaces_ignored_engine_request():
    pts = np.random.RandomState(1).randn(128, 3).astype(np.float32)
    res = knn(pts, np.zeros(3, np.float32), k=4, engine="pallas", session=_cpu())
    assert res.engine == "container:topk" and res.engine_requested == "pallas"
    with pytest.raises(ValueError, match="unknown engine"):
        knn(pts, np.zeros(3, np.float32), k=4, engine="spark", session=_cpu())
    assert "ignored (container-level plan)" in _port_plans()["knn"]


def test_node_cost_and_pick_engine_match_jax():
    """EXPLAIN's ``cost~`` figures and ``engine="auto"``'s choice: the port's
    fallback cost model equals JAX's, the crossover at
    ``PALLAS_AUTO_MAX_KEYS`` included."""
    from repro.core import cost as jcost
    from repro_torch.core import cost

    for k in (0, 1, 5, 256, 4095, 4096, 4097, 1 << 20):
        for engine in ("eager", "pallas", "naive"):
            assert cost.node_cost(engine, k) == jcost.node_cost(engine, k)
        assert cost.pick_engine(k) == jcost.pick_engine(k)
    assert cost.EAGER_FIXED_ROWS == jcost.EAGER_FIXED_ROWS


def test_reduce_edge_bytes_flat_case_matches_jax():
    """The combine-edge model on one node: every edge intra-node at the
    wire's width; and on 2 and 4 nodes, flat (every edge inter-node) and
    hierarchical (intra edges at full width, inter at the wire's), as JAX's
    (more in tests/test_torch_multihost.py)."""
    from repro.core.mapreduce import reduce_edge_bytes as jreb
    from repro_torch.core.mapreduce import reduce_edge_bytes

    for n_elems, full, wire_b, shards in ((20, 4, 4, 1), (20, 4, 2, 4), (64, 4, 1, 8)):
        assert reduce_edge_bytes(n_elems, full, wire_b, shards) == jreb(
            n_elems, full, wire_b, shards, 1, False)
        for nodes in (2, 4):
            for hier in (False, True):
                assert reduce_edge_bytes(n_elems, full, wire_b, 8, nodes, hier) == jreb(
                    n_elems, full, wire_b, 8, nodes, hier)
