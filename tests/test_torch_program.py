"""The port's fused programs (``repro_torch.core.program``) against the JAX
package's, mirroring ``tests/test_program.py``: one plan per state
signature, blocks of iterations and their dispatch / host-sync accounting,
``cond`` at block boundaries, hash targets threaded through the loop, the
int8 error-feedback residual within and across dispatches, bad states
rejected; and each of the six jobs in ``mode="program"`` against JAX's
``mode="program"`` and against the port's ``per_op`` on the same inputs.

Tolerances: π, word counts, kNN rows and integer sums exact (kNN's
distances ``rtol=1e-6``: per op they come from the rows on the host, in a
program from the scores, one rounding apart); f32 sums of
small rows ``rtol=1e-5``; PageRank 1e-5 max-abs, k-means centres 1e-4 and
inertia ``rtol=1e-4``, GMM log-likelihood ``1e-5`` relative and α, μ, Σ
``1e-4`` (the per-op parity tolerances of ``tests/test_torch_algorithms.py``
and ``tests/test_torch_gmm_knn.py``: the same sums in another order); the
int8 telescoping ``rtol=1e-4, atol=1e-3`` as in the reference.
"""
import numpy as np
import pytest
import torch

from repro.core import BlazeSession as JaxSession
from repro.core import algorithms as JA
from repro.data.synthetic import cluster_points, rmat_edges, zipf_corpus
from repro_torch.core import BlazeSession, DistRange, collect, topk
from repro_torch.core.algorithms import (
    counts_dict,
    estimate_pi,
    gmm_em,
    kmeans,
    knn,
    knn_full_sort,
    pagerank,
    wordcount,
)
from repro_torch.core.serialization import dequantize, quantize_with_feedback


def _cpu(n_shards=1):
    return BlazeSession(device="cpu", n_shards=n_shards)


def _sq_env_mapper(v, emit, env):
    emit(v % 4, v * v + 0.0 * env)


def _dyn_mapper(i, x, emit):
    emit(x[0].to(torch.int32) % 8, x[1])


def _rows(seed=0):
    rows = np.random.RandomState(seed).randn(64, 2).astype(np.float32)
    rows[:, 0] = np.random.RandomState(seed + 1).randint(0, 8, 64)
    return rows


def _sum_rows_oracle(rows, kmod=8):
    out = np.zeros(kmod)
    for r in rows:
        out[int(np.int32(r[0])) % kmod] += r[1]
    return out


# -- program basics ------------------------------------------------------------


def test_program_single_compile_many_blocks():
    sess = _cpu()

    def step(ctx, s):
        t = ctx.map_reduce(DistRange(0, 64, 1), _sq_env_mapper, "sum", torch.zeros(4),
                           env=s["x"])
        return {"x": s["x"] + t[0], "t": t}

    prog = sess.program(step)
    state = {"x": torch.zeros(()), "t": torch.zeros(4)}
    state, info = sess.run_loop(prog, state, max_iters=7, unroll=3)
    # 3 + 3 + 1 iterations, one plan
    assert info.iterations == 7 and info.dispatches == 3
    assert info.compiles == 1 and prog.stats.compiles == 1
    assert info.host_syncs == 0
    ref = float(np.sum((np.arange(64) ** 2)[np.arange(64) % 4 == 0]))
    assert float(state["x"]) == pytest.approx(7 * ref)
    assert sess.stats.program_compiles == 1
    assert sess.stats.program_dispatches == 3 and sess.stats.dispatches == 3


def test_program_cond_stops_at_block_boundary():
    sess = _cpu()

    def step(ctx, s):
        t = ctx.map_reduce(DistRange(0, 8, 1), _sq_env_mapper, "sum", torch.zeros(4),
                           env=s["x"])
        return {"x": s["x"] + 1.0, "t": t}

    prog = sess.program(step)
    state = {"x": torch.zeros(()), "t": torch.zeros(4)}
    state, info = sess.run_loop(prog, state, cond=lambda s: float(s["x"]) >= 4,
                                max_iters=100, unroll=4)
    assert info.converged and info.iterations == 4 and info.dispatches == 1
    assert info.host_syncs == 1 and sess.stats.host_syncs == 1


def test_program_multiple_ops_engines_and_sources_fuse():
    """Three ops over two sources and both combine engines in one program."""
    sess = _cpu()
    rows = _rows()
    pts = sess.distribute(rows)

    def step(ctx, s):
        a = ctx.map_reduce(pts, _dyn_mapper, "sum", torch.zeros(8), engine="eager")
        b = ctx.map_reduce(pts, _dyn_mapper, "sum", torch.zeros(8), engine="pallas")
        c = ctx.map_reduce(DistRange(0, 64, 1), _sq_env_mapper, "sum", torch.zeros(4),
                           env=s["acc"][0])
        return {"acc": s["acc"] + a + b + c[0] * 0.0}

    prog = sess.program(step)
    out = prog({"acc": torch.zeros(8)}, 2)
    assert prog.stats.compiles == 1 and prog.stats.dispatches == 1
    assert prog.stats.iterations == 2
    np.testing.assert_allclose(out["acc"].numpy(), 4 * _sum_rows_oracle(rows), rtol=1e-5)


def test_program_foreach_localvector_chain():
    """A foreach output (LocalVector) feeds a later op inside the program."""
    sess = _cpu(2)
    rows = _rows()
    pts = sess.distribute(rows)

    def step(ctx, s):
        doubled = ctx.foreach(pts, lambda x, e: x * e, env=s["scale"])
        quad = ctx.foreach(doubled, lambda x: x * 2.0)
        out = ctx.map_reduce(quad, _dyn_mapper, "sum", torch.zeros(8))
        return {"scale": s["scale"], "out": out}

    prog = sess.program(step)
    out = prog({"scale": torch.tensor(2.0), "out": torch.zeros(8)}, 1)
    np.testing.assert_allclose(out["out"].numpy(), _sum_rows_oracle(rows * 4.0),
                               rtol=1e-5)
    assert "local[0]" in sess.explain(prog)


def test_program_recompiles_only_on_state_signature_change():
    sess = _cpu()

    def step(ctx, s):
        t = ctx.map_reduce(DistRange(0, 32, 1), _sq_env_mapper, "sum", torch.zeros(4),
                           env=s["x"])
        return {"x": s["x"] + t[0], "t": t}

    prog = sess.program(step)
    s32 = {"x": torch.zeros(()), "t": torch.zeros(4)}
    prog(s32, 2)
    prog(s32, 5)  # another block size, the same plan
    prog({"x": torch.ones(()), "t": torch.ones(4)}, 1)  # new values, same signature
    assert prog.stats.compiles == 1

    def ok_step(ctx, s):
        t = ctx.map_reduce(DistRange(0, 32, 1), _sq_env_mapper, "sum", torch.zeros(4),
                           env=s["x"][0])
        return {"x": s["x"] + t[0], "t": t}

    prog2 = _cpu().program(ok_step)
    prog2({"x": torch.zeros(2), "t": torch.zeros(4)}, 1)
    prog2({"x": torch.zeros(3), "t": torch.zeros(4)}, 1)
    assert prog2.stats.compiles == 2  # a new signature: a deliberate miss


def test_program_hash_target_threads_per_shard_state():
    """A hash target's tables are threaded through the iterations and
    accumulate across them; the original container is never changed."""
    sess = _cpu(2)
    hm = sess.make_dist_hashmap(64, (), torch.float32, "sum")

    def hash_step(ctx, s):
        ctx.map_reduce(DistRange(0, 8, 1), _sq_env_mapper, "sum", hm, env=s)
        return s

    prog = sess.program(hash_step)
    prog(torch.zeros(()), 3)
    assert prog.hash_slots == 1
    got = {int(k): float(v) for k, v in prog.hash_result(hm).to_dict().items()}
    want = {k: 3.0 * sum(v * v for v in range(8) if v % 4 == k) for k in range(4)}
    assert got == want
    assert hm.size() == 0
    prog(torch.zeros(()), 2)  # the tables carry across dispatches
    got = {int(k): float(v) for k, v in prog.hash_result(hm).to_dict().items()}
    assert got == {k: 5.0 / 3.0 * v for k, v in want.items()}
    prog.reset_carry()
    prog(torch.zeros(()), 1)
    got = {int(k): float(v) for k, v in prog.hash_result(hm).to_dict().items()}
    assert got == {k: v / 3.0 for k, v in want.items()}


def test_program_rejects_bad_state():
    sess = _cpu()

    def shape_shifting_step(ctx, s):
        return ctx.map_reduce(DistRange(0, 8, 1), _sq_env_mapper, "sum", torch.zeros(4),
                              env=s[0])  # [4] out of a [1] state

    with pytest.raises(ValueError, match="state"):
        sess.program(shape_shifting_step)(torch.zeros(1), 1)

    def restructuring_step(ctx, s):
        return {"x": s["x"], "y": s["x"]}

    with pytest.raises(ValueError, match="structure"):
        sess.program(restructuring_step)({"x": torch.zeros(1)}, 1)


# -- error-feedback int8 wire --------------------------------------------------


def test_quantize_with_feedback_telescopes_exactly():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(300).astype(np.float32))
    residual = torch.zeros_like(x)
    total = torch.zeros_like(x)
    for _ in range(10):
        q, residual = quantize_with_feedback(x, residual, "int8")
        total = total + dequantize(q, x)
    np.testing.assert_allclose((total + residual).numpy(), 10.0 * x.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert float(residual.abs().max()) <= 2 * float(x.abs().max()) / 127.0


def test_quantize_feedback_beats_no_feedback_over_rounds():
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.rand(512).astype(np.float32) - 0.3) * 1e-2)
    exact = 10.0 * x.numpy()
    residual = torch.zeros_like(x)
    with_fb = torch.zeros_like(x)
    without = torch.zeros_like(x)
    for _ in range(10):
        q, residual = quantize_with_feedback(x, residual, "int8")
        with_fb = with_fb + dequantize(q, x)
        q2, _ = quantize_with_feedback(x, torch.zeros_like(x), "int8")
        without = without + dequantize(q2, x)
    assert np.abs(with_fb.numpy() - exact).max() <= np.abs(without.numpy() - exact).max()


def test_program_int8_wire_carries_residual_and_stays_accurate():
    sess = _cpu()
    rows = _rows()
    pts = sess.distribute(rows)

    def step(ctx, s):
        inc = ctx.map_reduce(pts, _dyn_mapper, "sum", torch.zeros(8), wire="int8")
        return {"acc": s["acc"] + inc}

    prog = sess.program(step)
    out = prog({"acc": torch.zeros(8)}, 10)
    assert prog.feedback_slots == 1
    assert "int8 feedback" in sess.explain(prog)
    ref = 10.0 * _sum_rows_oracle(rows)
    assert np.abs(out["acc"].numpy() - ref).max() / np.abs(ref).max() < 2e-2


@pytest.mark.parametrize("n_shards", (1, 4))
def test_program_int8_residual_survives_across_dispatches(n_shards):
    """acc + Σ_shards residual == N · exact after any mix of dispatch sizes
    only if the residual is fed back between them."""
    sess = _cpu(n_shards)
    rows = _rows(2)
    pts = sess.distribute(rows)

    def step(ctx, s):
        inc = ctx.map_reduce(pts, _dyn_mapper, "sum", torch.zeros(8), wire="int8")
        return {"acc": s["acc"] + inc}

    prog = sess.program(step)
    state = {"acc": torch.zeros(8)}
    for _ in range(7):
        state = prog(state, 1)
    state = prog(state, 3)
    assert prog.stats.dispatches == 8 and prog.stats.iterations == 10
    (residual,) = prog.export_carry(state)["residual"]
    assert residual.shape == (n_shards, 8)
    assert float(residual.abs().max()) > 0.0  # the carry is live
    np.testing.assert_allclose(state["acc"].numpy() + residual.sum(0).numpy(),
                               10.0 * _sum_rows_oracle(rows), rtol=1e-4, atol=1e-3)
    prog.import_carry(state, {"residual": [torch.zeros_like(residual)], "hash": []})
    assert float(prog.export_carry(state)["residual"][0].abs().max()) == 0.0


# -- topk inside and outside programs --------------------------------------------


def test_topk_program_matches_container_topk():
    """``ctx.topk`` (on the device) and the container's ``topk`` (via the
    host) select the same rows, at 1 and 4 shards."""
    rng = np.random.RandomState(0)
    data = rng.randn(256).astype(np.float32)
    for n_shards in (1, 4):
        sess = _cpu(n_shards)
        v = sess.distribute(data)
        want = topk(v, 5, n_shards=n_shards)

        def step(ctx, s):
            rows, scores = ctx.topk(v, 5)
            return {"rows": rows, "scores": scores}

        out = sess.program(step)({"rows": torch.zeros(5), "scores": torch.zeros(5)}, 1)
        np.testing.assert_array_equal(np.sort(out["rows"].numpy()), np.sort(want))
        np.testing.assert_allclose(np.sort(want), np.sort(collect(v))[-5:], rtol=1e-6)


def test_knn_program_reuses_one_plan_across_queries():
    """The query rides in the state, so one program serves every query."""
    pts = np.random.RandomState(0).randn(512, 3).astype(np.float32)
    sess = _cpu(2)
    from repro_torch.core.algorithms.knn import _program_step

    pv = sess.distribute(pts)
    prog = sess.program(_program_step(pv, 8, "auto"))
    for i in range(4):
        q = np.full(3, float(i), np.float32)
        state = {"q": torch.from_numpy(q), "neighbors": torch.zeros(8, 3),
                 "scores": torch.zeros(8)}
        out = prog(state, 1)
        ref = knn_full_sort(pts, q, k=8)
        np.testing.assert_allclose(np.sort(np.sqrt(-out["scores"].numpy())),
                                   np.sort(ref.distances), rtol=1e-5)
    assert prog.stats.compiles == 1


def test_topk_correct_with_score_fn():
    rows = np.stack([np.arange(64.0), 64.0 - np.arange(64.0)], 1).astype(np.float32)
    sess = _cpu()
    v = sess.distribute(rows)

    def step(ctx, s):
        got, _ = ctx.topk(v, 4, score_fn=lambda r: r[1])
        return {"got": got}

    out = sess.program(step)({"got": torch.zeros(4, 2)}, 1)
    assert set(out["got"][:, 0].numpy().astype(int).tolist()) == {0, 1, 2, 3}
    np.testing.assert_array_equal(np.sort(out["got"].numpy(), 0),
                                  np.sort(topk(v, 4, score_fn=lambda r: r[1]), 0))


def test_hashmap_items_matches_to_dict():
    import collections

    sess = _cpu()
    lines = np.random.RandomState(0).randint(0, 50, (64, 8)).astype(np.int32)
    lv = sess.distribute(lines)

    def tok(i, toks, emit):
        emit(toks, 1, mask=toks >= 0)

    hm = sess.make_dist_hashmap(256, (), torch.int32, "sum")
    hm = sess.map_reduce(lv, tok, "sum", hm)
    keys, vals = hm.items()
    assert keys.shape[0] == hm.size() == len(hm.to_dict())
    got = {int(k): int(v) for k, v in zip(keys, vals)}
    assert got == dict(collections.Counter(lines.reshape(-1).tolist()))


def test_later_slices_of_programs_raise():
    sess = _cpu()

    def step(ctx, s):
        return s

    prog = sess.program(step)
    # Tuning, checkpoints, streams and fault degradation are ported
    # (tests/test_torch_tuning.py, test_torch_checkpoint.py,
    # test_torch_streaming.py, test_torch_faults.py): a program without
    # chunked sources is refused by run_stream as in the reference, a resume
    # without a checkpoint directory is an error, and degrading a program
    # with no kernel node degrades nothing.
    with pytest.raises(ValueError, match="no chunked"):
        sess.run_stream(prog, torch.zeros(1))
    with pytest.raises(ValueError, match="checkpoint"):
        sess.run_loop(prog, torch.zeros(1), max_iters=1, resume=True)
    assert prog.degrade() == 0


# -- the six jobs in program mode: against JAX's program mode and per_op -------


ENGINES = ("eager", "pallas")


@pytest.mark.parametrize("engine", ENGINES)
def test_pi_program_matches_jax(engine):
    got = estimate_pi(65_537, engine=engine, mode="program", session=_cpu())
    assert got == JA.estimate_pi(65_537, engine=engine, mode="program", session=JaxSession())
    assert got == estimate_pi(65_537, engine=engine, session=_cpu())


@pytest.mark.parametrize("engine", ENGINES)
def test_wordcount_program_matches_jax(engine):
    lines, _ = zipf_corpus(64, 16, 500, seed=0)
    got = wordcount(lines, engine=engine, mode="program", iters=3, unroll=2,
                    session=_cpu(2))
    want = JA.wordcount(lines, engine=engine, mode="program", iters=3, unroll=2,
                        session=JaxSession())
    per_op = wordcount(lines, engine=engine, iters=3, session=_cpu(2))
    jd = {int(k): int(v) for k, v in want.counts.to_dict().items()}
    assert counts_dict(got.counts) == jd == counts_dict(per_op.counts)
    assert got.counts.total_overflow() == 0
    assert (got.dispatches, got.program_compiles, got.iterations) == (
        want.dispatches, want.program_compiles, want.iterations) == (2, 1, 3)
    assert got.host_syncs == want.host_syncs == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_pagerank_program_matches_jax_and_per_op(engine):
    edges = rmat_edges(7, 8, seed=2)
    got = pagerank(edges, 128, tol=0.0, max_iters=10, engine=engine, mode="program",
                   unroll=4, session=_cpu())
    want = JA.pagerank(edges, 128, tol=0.0, max_iters=10, engine=engine,
                       mode="program", unroll=4, session=JaxSession())
    per_op = pagerank(edges, 128, tol=0.0, max_iters=10, engine=engine, session=_cpu())
    assert float(np.abs(got.scores - want.scores).max()) <= 1e-5
    assert float(np.abs(got.scores - per_op.scores).max()) <= 1e-5
    for f in ("iterations", "dispatches", "host_syncs", "program_compiles",
              "collectives_per_iter", "compiles"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.dispatches, got.host_syncs) == (3, 3)


@pytest.mark.parametrize("engine", ENGINES)
def test_kmeans_program_matches_jax_and_per_op(engine):
    pts, _ = cluster_points(2000, 3, 4, seed=1)
    init = pts[:4].copy()
    got = kmeans(pts, 4, init_centers=init, tol=0.0, max_iters=10, engine=engine,
                 mode="program", unroll=5, session=_cpu(2))
    want = JA.kmeans(pts, 4, init_centers=init, tol=0.0, max_iters=10, engine=engine,
                     mode="program", unroll=5, session=JaxSession())
    per_op = kmeans(pts, 4, init_centers=init, tol=0.0, max_iters=10, engine=engine,
                    session=_cpu(2))
    for other in (want, per_op):
        assert float(np.abs(got.centers - other.centers).max()) <= 1e-4
        assert abs(got.inertia - other.inertia) <= 1e-4 * abs(other.inertia)
    for f in ("iterations", "dispatches", "host_syncs", "program_compiles",
              "collectives_per_iter", "compiles"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("engine", ENGINES)
def test_gmm_program_matches_jax_and_per_op(engine):
    pts, _ = cluster_points(803, 3, 3, seed=4)
    init = pts[:3].copy()
    got = gmm_em(pts, 3, init_mu=init, tol=0.0, max_iters=5, engine=engine,
                 mode="program", unroll=5, session=_cpu(2))
    want = JA.gmm_em(pts, 3, init_mu=init, tol=0.0, max_iters=5, engine=engine,
                     mode="program", unroll=5, session=JaxSession())
    per_op = gmm_em(pts, 3, init_mu=init, tol=0.0, max_iters=5, engine=engine,
                    session=_cpu(2))
    for other in (want, per_op):
        assert abs(got.log_likelihood - other.log_likelihood) <= 1e-5 * abs(
            other.log_likelihood)
        for name in ("alpha", "mu", "sigma"):
            np.testing.assert_allclose(getattr(got, name), getattr(other, name),
                                       atol=1e-4, rtol=0, err_msg=name)
    for f in ("iterations", "dispatches", "host_syncs", "program_compiles",
              "collectives_per_iter"):
        assert getattr(got, f) == getattr(want, f), f


def test_knn_program_matches_jax_and_per_op():
    pts, _ = cluster_points(4001, 4, 3, seed=9)
    q = np.zeros(4, np.float32)
    got = knn(pts, q, 64, mode="program", session=_cpu(4))
    want = JA.knn(pts, q, 64, mode="program", session=JaxSession())
    per_op = knn(pts, q, 64, session=_cpu(4))
    for other in (want, per_op):
        np.testing.assert_allclose(np.sort(got.distances), np.sort(other.distances),
                                   rtol=1e-6)
        assert {tuple(r) for r in got.neighbors.tolist()} == {
            tuple(r) for r in np.asarray(other.neighbors).tolist()}
    assert got.wire_candidates == 256
