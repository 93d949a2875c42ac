"""Measured autotuning in the port, mirroring ``tests/test_tuning.py``: one
plan measures once a session and every later appearance (per op, in
``run_loop`` programs) reuses the winner; another ``key_range`` or dtype is
another plan and measures again; EXPLAIN annotates the tuned node; every
dense and hash candidate gives the same bits on exact inputs, equal to the
reference's untuned result; winners saved to disk load without measuring.

The reference's two serving cases (``test_serve_tuning_stats_conservation``,
``test_serve_untuned_plans_are_fallback``) run against the port's
``BlazeServer`` on the CPU.

On the CPU every wrapper runs its plain version, so the times measured here
are the CPU's and only the counters and the results are checked.  Exact
comparisons throughout: integer counts, and k-means on integer-valued points
whose per-centre sums are exact in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlazeSession as JaxSession
from repro.core import containers as JC
from repro.core.algorithms.kmeans import _program_step as _jkmeans_step
from repro_torch.core import BlazeSession, cost
from repro_torch.core import plan as plan_mod
from repro_torch.core.algorithms.kmeans import _program_step as _kmeans_step
from repro_torch.core.reducers import get_reducer

VOCAB = 40
N_TOKENS = 192


def _cpu(**kw):
    return BlazeSession(device="cpu", **kw)


def _tokens(seed=0, n=N_TOKENS, dtype=np.int32):
    return np.random.RandomState(seed).randint(0, VOCAB, size=(n,)).astype(dtype)


def _wc_mapper(i, tok, emit):
    emit(tok, 1, mask=tok >= 0)


def _hm(sess, dtype=torch.int32):
    return sess.make_dist_hashmap(4 * VOCAB, (), dtype, "sum")


def _counts(hm):
    keys, vals = hm.items()
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]


def _wc(sess, *, tune=False, key_range=VOCAB, dtype=np.int32):
    lines = sess.distribute(_tokens(dtype=dtype))
    tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
    out = sess.map_reduce(lines, _wc_mapper, "sum", _hm(sess, tdt),
                          key_range=key_range, tune=tune)
    return _counts(out)


def _jax_counts():
    sess = JaxSession()
    lines = JC.distribute(_tokens(), sess.mesh)
    hm = JC.make_dist_hashmap(sess.mesh, 4 * VOCAB, (), jnp.int32, "sum")
    return _counts(sess.map_reduce(lines, _wc_mapper, "sum", hm, key_range=VOCAB))


# -- measure-once semantics ---------------------------------------------------


def test_map_reduce_measures_once_and_reuses():
    sess = _cpu()
    got = _wc(sess, tune=True)
    first = sess.stats.tune_measurements
    cands = cost.hash_tuning_candidates(1, "sum", torch.int32, key_range=VOCAB)
    assert first == len(cands) == len(sess.tune_log)
    assert len(sess.tuning) == 1
    (tk, cfg), = sess.tuning.items()
    assert cfg.source == "measured" and cfg.wall_s is not None
    assert cfg in cands
    # resubmission of the same plan: no new measurement, the same counts
    again = _wc(sess, tune=True)
    _wc(sess, tune=False)
    assert sess.stats.tune_measurements == first and len(sess.tuning) == 1
    want = _jax_counts()
    for a, b, c in zip(got, again, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def test_different_key_range_or_dtype_remeasures():
    sess = _cpu()
    _wc(sess, tune=True, key_range=VOCAB)
    assert len(sess.tuning) == 1
    _wc(sess, tune=True, key_range=2 * VOCAB)  # another plan hash
    assert len(sess.tuning) == 2
    _wc(sess, tune=True, dtype=np.float32)  # another value dtype
    assert len(sess.tuning) == 3


def test_program_tune_measures_once_across_run_loop_blocks():
    sess = _cpu()
    pts = np.random.RandomState(0).randint(-3, 4, size=(256, 4)).astype(np.float32)
    step, state0 = _kmeans_step(sess.distribute(pts), 8, 4, "auto", "none")
    prog = sess.program(step, tune=True)
    c0 = torch.as_tensor(pts[:8])
    out, _ = sess.run_loop(prog, state0(c0), max_iters=6, unroll=2)
    first = sess.stats.tune_measurements
    assert first == len(cost.dense_tuning_candidates(8, 6, "sum", torch.float32))
    assert len(prog.tune_walls) == first
    # more blocks, a second tuned program and an untuned one: no re-measure
    sess.run_loop(prog, state0(c0), max_iters=4)
    prog2 = sess.program(step, tune=True)
    out2, _ = sess.run_loop(prog2, state0(c0), max_iters=6, unroll=2)
    assert sess.stats.tune_measurements == first
    assert torch.equal(out["centers"], out2["centers"])
    # the tuned program against the reference's untuned one
    js = JaxSession()
    jstep, jstate0 = _jkmeans_step(JC.distribute(pts, js.mesh), 8, 4, "auto", "none")
    jout, _ = js.run_loop(js.program(jstep), jstate0(jnp.asarray(pts[:8])), max_iters=6,
                          unroll=2)
    np.testing.assert_array_equal(out["centers"].numpy(), np.asarray(jout["centers"]))


def test_tuned_node_annotated_in_plan():
    sess = _cpu()
    pts = np.random.RandomState(1).randn(128, 4).astype(np.float32)
    step, state0 = _kmeans_step(sess.distribute(pts), 4, 4, "auto", "none")
    prog = sess.program(step, tune=True)
    prog.build(state0(torch.as_tensor(pts[:4])))
    nodes = [n for n in prog.plan.mapreduce_nodes() if not n.dead and n.cse_of is None]
    tuned = next(n for n in nodes if n.tuned is not None)
    assert tuned.tuned.source == "measured"
    assert tuned.engine == tuned.tuned.engine
    rendered = sess.explain(prog)
    assert "tuned measured:" in rendered and "cost~" in rendered
    # the node's key is its untuned hash: the tuned override moves no key
    assert tuned.tune_key in sess.tuning and "requested" not in rendered


# -- bit-equality across every candidate config -------------------------------


@pytest.mark.parametrize("cfg", cost.dense_tuning_candidates(8, 6, "sum", torch.float32),
                         ids=lambda c: c.describe())
def test_dense_candidates_bit_identical(cfg):
    pts = np.random.RandomState(2).randint(-4, 5, size=(256, 4)).astype(np.float32)
    k = 8
    probe = _cpu()
    step, state0 = _kmeans_step(probe.distribute(pts), k, 4, "auto", "none")
    node = next(n for n in probe.program(step).build(state0(torch.as_tensor(pts[:k])))
                .mapreduce_nodes() if not n.dead and n.cse_of is None)
    sess = _cpu()
    sess.tuning.put(node.tune_key, cfg)
    step, state0 = _kmeans_step(sess.distribute(pts), k, 4, "auto", "none")
    prog = sess.program(step)
    out, _ = sess.run_loop(prog, state0(torch.as_tensor(pts[:k])), max_iters=5)
    applied = next(n for n in prog.plan.mapreduce_nodes() if n.tuned is not None)
    assert applied.tuned == cfg and applied.engine == cfg.engine
    js = JaxSession()
    jstep, jstate0 = _jkmeans_step(JC.distribute(pts, js.mesh), k, 4, "auto", "none")
    jout, _ = js.run_loop(js.program(jstep), jstate0(jnp.asarray(pts[:k])), max_iters=5)
    np.testing.assert_array_equal(out["centers"].numpy(), np.asarray(jout["centers"]))


@pytest.mark.parametrize("cfg", cost.hash_tuning_candidates(1, "sum", torch.int32,
                                                            key_range=VOCAB),
                         ids=lambda c: c.describe())
def test_hash_candidates_bit_identical(cfg):
    probe = _cpu()
    node = plan_mod.build_mapreduce_node(
        idx=0, kind="vector", src="s", source_key=None, mapper=_wc_mapper,
        red=get_reducer("sum"), target=_hm(probe), engine="auto", wire="none",
        key_range=VOCAB, env=None)
    sess = _cpu()
    sess.tuning.put(node.tune_key, cfg)
    got = _wc(sess, tune=False)
    assert sess.stats.tune_measurements == 0
    for a, b in zip(got, _jax_counts()):
        np.testing.assert_array_equal(a, b)


# -- persistence --------------------------------------------------------------


def test_save_load_skips_measurement(tmp_path):
    p = str(tmp_path / "tuning.json")
    sess = _cpu(tuning_path=p)
    _wc(sess, tune=True)
    assert sess.stats.tune_measurements > 0
    assert sess.save_tuning() == p
    s2 = _cpu(tuning_path=p)
    assert len(s2.tuning) == len(sess.tuning)
    _wc(s2, tune=True)
    assert s2.stats.tune_measurements == 0  # the winner came off disk
    s3 = _cpu()
    assert s3.load_tuning(p) == 1
    _wc(s3, tune=True)
    assert s3.stats.tune_measurements == 0
    with pytest.raises(ValueError):
        _cpu().save_tuning()  # no path configured anywhere


def test_chunked_sources_are_not_tuned():
    sess = _cpu()
    cv = sess.chunked(_tokens(), block_rows=64)
    out = sess.map_reduce(cv, _wc_mapper, "sum", _hm(sess), key_range=VOCAB, tune=True)
    assert sess.stats.tune_measurements == 0 and len(sess.tuning) == 0
    for a, b in zip(_counts(out), _jax_counts()):
        np.testing.assert_array_equal(a, b)


# -- serving ------------------------------------------------------------------


def test_serve_tuning_stats_conservation():
    from repro_torch.serve import BlazeServer

    rng = np.random.RandomState(0)
    pts = rng.randn(128, 4).astype(np.float32)
    lines = rng.randint(0, VOCAB, size=(128, 1)).astype(np.int32)
    srv = BlazeServer(device="cpu", tune=True)
    srv.register_dataset("points", pts)
    srv.register_dataset("lines", lines, vocab_size=VOCAB)
    srv.start()
    try:
        srv.submit_and_wait(
            "t", "kmeans", {"k": 4, "iters": 2, "engine": "auto"}
        )
        srv.submit_and_wait("t", "wordcount", {"engine": "auto"})
        measured = srv.session.stats.tune_measurements
        assert measured > 0
        # resubmission: plan-cache hit, no re-measure
        srv.submit_and_wait(
            "t", "kmeans", {"k": 4, "iters": 2, "engine": "auto"}
        )
        assert srv.session.stats.tune_measurements == measured
        snap = srv.stats_snapshot()
        t = snap["tuning"]
        assert (
            t["tuned_plans"] + t["fallback_plans"]
            == snap["resident_programs"]
        )
        assert t["tuned_plans"] >= 1
        for info in t["plans"].values():
            for op in info["ops"]:
                assert op["source"] in ("measured", "loaded", "model",
                                        "fallback")
                if op["source"] == "model":
                    assert op["config"] is None
                else:
                    assert op["config"]
        assert t["cache"]["measurements"] == measured
    finally:
        srv.stop()


def test_serve_untuned_plans_are_fallback():
    from repro_torch.serve import BlazeServer

    rng = np.random.RandomState(0)
    srv = BlazeServer(device="cpu")  # tune off: everything rides the model
    srv.register_dataset("points", rng.randn(64, 4).astype(np.float32))
    srv.start()
    try:
        srv.submit_and_wait(
            "t", "kmeans", {"k": 4, "iters": 2, "engine": "auto"}
        )
        snap = srv.stats_snapshot()
        t = snap["tuning"]
        assert t["tuned_plans"] == 0
        assert t["fallback_plans"] == snap["resident_programs"] == 1
        assert srv.session.stats.tune_measurements == 0
    finally:
        srv.stop()
