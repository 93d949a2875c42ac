"""The port's fault injection and supervised dispatch against the reference's
chaos suite (``tests/test_faults.py``).

Each case runs one seeded schedule through ``repro_torch`` and through
``repro``, each package with its own registry (``repro_torch.core.faults``,
``repro.core.faults``), and holds the port's ledger to the reference's: the
same dispositions, both balanced (``injected_total == retried + degraded +
escalated + fatal + absorbed``), and the same hits at ``dispatch``,
``kernel.segment``, ``kernel.hash`` and ``collective``.  The reference hits
``collective`` while ``jax.jit`` traces; the port on a stage's runs, and a
program's runs after discovery, until one succeeds, which is what makes
those counts comparable.  They part after a run that took a ``collective``
fault: ``jax.jit`` then traces that stage again on every later call, the
port does not.  The one case whose schedule does that (per-op PageRank
under a probabilistic ``collective`` rule) compares the kinds of
disposition, not their numbers.  The JAX side runs under ``jax.set_mesh`` of its session's
mesh, so the arrays it makes on the host are placed on the mesh as its jit
outputs are; otherwise ``jax.jit`` traces a stage again the first time an
input's placement changes (an array made on the host, then one a jit
returned), a second ``collective`` hit with no counterpart in the port,
where a tensor has no placement beyond its device.  Inside the port a
faulted run is bit-equal to the fault-free
one, as the reference holds itself; against JAX, results meet the parity
tolerances of the other ``test_torch_*`` files (integers exactly, k-means
centres within 1e-4, PageRank within ``atol=1e-7``, the small float
programs within ``rtol=1e-6``).

All 32 of the reference's cases are here: its three ``serve`` cases run the
port's ``BlazeServer`` beside the reference's, each on a session with fast
supervision, armed by one rule in both registries.  The tuning case
compares the ledger but not the hit counts: the port's candidate grid is its
own (``repro_torch/core/cost.py``), so it dispatches other candidates.  Two
more cases are the port's own: a program rediscovered after ``degrade()``
keeps its carry's tensors, and a real error propagates where the reference
degrades (per op, in a program and in a tuning candidate).  And
``tests/test_multihost.py``'s ``collective.inter`` case runs here on the
port's (2x4) mesh, held to the reference's assertions; its JAX side, which
needs eight devices, is in ``tests/test_torch_multihost.py``.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import containers as JC
from repro.core import faults as jf
from repro.core.algorithms.kmeans import kmeans as jkmeans
from repro.core.algorithms.pagerank import pagerank as jpagerank
from repro.core.session import BlazeSession as JaxSession
from repro_torch.core import BlazeSession
from repro_torch.core import faults as tf
from repro_torch.core.algorithms.kmeans import kmeans
from repro_torch.core.algorithms.pagerank import pagerank
from repro_torch.launch.mesh import make_node_data_mesh

# Fast supervision for tests: no sleeps, no wall-clock deadline.
JFAST = jf.RetryPolicy(attempts=3, backoff_s=0.0, multiplier=1.0, deadline_s=None)
FAST = tf.RetryPolicy(attempts=3, backoff_s=0.0, multiplier=1.0, deadline_s=None)
COMPARED = ("dispatch", "kernel.segment", "kernel.hash", "collective")


@pytest.fixture(autouse=True)
def _clean_registries():
    """Every case starts and ends with both registries disarmed and their
    ledgers zeroed (ignoring any ambient BLAZE_FAULTS); the JAX side places
    what it makes on its mesh (module docstring)."""
    jf.reset(env=False)
    tf.reset(env=False)
    with jax.set_mesh(JC.data_mesh()):
        yield
    jf.reset(env=False)
    tf.reset(env=False)


def _arm(point, **kw):
    """The same rule in both registries."""
    jf.configure(point, **kw)
    tf.configure(point, **kw)


def _jsess(**kw):
    kw.setdefault("retry", JFAST)
    return JaxSession(**kw)


def _sess(**kw):
    kw.setdefault("retry", FAST)
    return BlazeSession(device="cpu", **kw)


def _same_ledger(hits=True, balanced=True, counts=True, **expect):
    """Both ledgers balanced (or, with ``balanced=False``, both not), with
    the same dispositions (and those in ``expect``), and the same hits at
    the compared points.  ``counts=False``: the same kinds of disposition
    and of injected point, not their numbers (module docstring)."""
    js, ts = jf.snapshot(), tf.snapshot()
    assert js["balanced"] is ts["balanced"] is balanced, (js, ts)
    if not counts:
        def kinds(d):
            return {k for k, v in d.items() if v}

        assert kinds(ts["dispositions"]) == kinds(js["dispositions"]), (js, ts)
        assert kinds(ts["injected"]) == kinds(js["injected"]), (js, ts)
        return js, ts
    assert ts["dispositions"] == js["dispositions"], (js, ts)
    assert ts["injected"] == js["injected"], (js, ts)
    for k, v in expect.items():
        assert ts["dispositions"][k] == v, (k, ts)
    if hits:
        got = {p: ts["hits"].get(p, 0) for p in COMPARED}
        want = {p: js["hits"].get(p, 0) for p in COMPARED}
        assert got == want, (got, want)
    return js, ts


def _jsq(i, x, emit):
    emit(jnp.asarray(x, jnp.int32) % 8, x)


def _sq(i, x, emit):
    emit(x.to(torch.int32) % 8, x)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- registry and rules -----------------------------------------------------


def test_rule_needs_exactly_one_trigger():
    for F in (jf, tf):
        with pytest.raises(ValueError):
            F.FaultRule("dispatch")
        with pytest.raises(ValueError):
            F.FaultRule("dispatch", at=1, every=2)
        with pytest.raises(ValueError):
            F.FaultRule("dispatch", at=0)
    assert tf.POINTS == jf.POINTS and tf.DISPOSITIONS == jf.DISPOSITIONS


def test_retry_policy_validation():
    for F in (jf, tf):
        with pytest.raises(ValueError):
            F.RetryPolicy(attempts=0)
        with pytest.raises(ValueError):
            F.RetryPolicy(multiplier=0.5)
    assert (tf.RetryPolicy().__dict__ == jf.RetryPolicy().__dict__)


def test_env_spec_parsing(monkeypatch):
    monkeypatch.setenv(tf.ENV_VAR, "dispatch:at=3;kernel.hash:p=0.1,seed=42,fatal")
    assert tf.ENV_VAR == jf.ENV_VAR
    for F in (jf, tf):
        F.reset()
        snap = F.snapshot()
        assert snap["armed"] and snap["rules"] == 2
        rules = {r.point: r for r in F.registry._rules}
        assert rules["dispatch"].at == 3 and not rules["dispatch"].fatal
        assert rules["kernel.hash"].p == 0.1
        assert rules["kernel.hash"].seed == 42 and rules["kernel.hash"].fatal
    assert tf._parse_env("a:every=2,times=1;b:p=0.5,fatal=yes") == \
        jf._parse_env("a:every=2,times=1;b:p=0.5,fatal=yes")


def test_env_spec_rejects_unknown_knob(monkeypatch):
    monkeypatch.setenv(tf.ENV_VAR, "dispatch:bogus=1")
    for F in (jf, tf):
        with pytest.raises(ValueError):
            F.reset()
        F.reset(env=False)


def test_probabilistic_schedule_is_deterministic():
    def schedule(F):
        F.reset(env=False)
        F.configure("dispatch", p=0.3, seed=7)
        fired = []
        for i in range(50):
            try:
                F.fault_point("dispatch")
            except F.TransientFault:
                fired.append(i)
        return fired

    a, b = schedule(tf), schedule(tf)
    assert a == b and len(a) > 0  # replayable, and it really fires
    assert a == schedule(jf)  # the reference's schedule, hit for hit


def test_ledger_disposes_each_fault_once():
    for F in (jf, tf):
        F.configure("dispatch", at=1)
        with pytest.raises(F.TransientFault) as ei:
            F.fault_point("dispatch")
        F.record("retried", ei.value)
        F.record("fatal", ei.value)  # a second disposition: no-op
        F.record("retried", ValueError("real"))  # not injected: no-op
        with pytest.raises(ValueError):
            F.record("vanished", ei.value)
    _same_ledger(retried=1, fatal=0)


def test_inject_scopes_the_rule():
    for F in (jf, tf):
        with F.inject("dispatch", every=1):
            with pytest.raises(F.TransientFault):
                F.fault_point("dispatch")
        F.fault_point("dispatch")  # disarmed again: must not raise
        assert F.snapshot()["injected_total"] == 1
    _same_ledger(balanced=False)  # nothing disposed of the one fault


# -- supervised per-op dispatch ---------------------------------------------


def test_transient_dispatch_fault_retries_bit_equal():
    x = np.arange(64, dtype=np.float32)
    js, s = _jsess(), _sess()
    jsrc, src = js.distribute(x), s.distribute(x)
    jref = js.map_reduce(jsrc, _jsq, "sum", jnp.zeros((8,), jnp.float32))
    ref = s.map_reduce(src, _sq, "sum", torch.zeros(8))
    # hits are counted only while armed, so the next dispatch is hit 1
    _arm("dispatch", at=1)
    jout = js.map_reduce(jsrc, _jsq, "sum", jnp.zeros((8,), jnp.float32))
    out = s.map_reduce(src, _sq, "sum", torch.zeros(8))
    assert torch.equal(out, ref)
    np.testing.assert_array_equal(_np(out), np.asarray(jout))
    np.testing.assert_array_equal(_np(ref), np.asarray(jref))
    assert s.stats.retries == js.stats.retries == 1
    assert s.cache_info()["retries"] == 1
    _same_ledger(retried=1)


def test_retry_budget_exhaustion_is_fatal():
    x = np.arange(16, dtype=np.float32)
    js, s = _jsess(), _sess()
    _arm("dispatch", every=1)  # every attempt faults
    with pytest.raises(jf.TransientFault):
        js.map_reduce(js.distribute(x), _jsq, "sum", jnp.zeros((8,), jnp.float32))
    with pytest.raises(tf.TransientFault):
        s.map_reduce(s.distribute(x), _sq, "sum", torch.zeros(8))
    # attempts=3: two retries, then the third failure is recorded fatal
    _same_ledger(retried=2, fatal=1)


def test_fatal_fault_propagates_immediately():
    x = np.arange(16, dtype=np.float32)
    js, s = _jsess(), _sess()
    _arm("dispatch", at=1, fatal=True)
    with pytest.raises(jf.FatalFault):
        js.map_reduce(js.distribute(x), _jsq, "sum", jnp.zeros((8,), jnp.float32))
    with pytest.raises(tf.FatalFault):
        s.map_reduce(s.distribute(x), _sq, "sum", torch.zeros(8))
    assert s.stats.retries == js.stats.retries == 0
    _same_ledger(fatal=1)


def test_unsupervised_session_propagates_raw():
    x = np.arange(16, dtype=np.float32)
    js, s = JaxSession(retry=None), BlazeSession(device="cpu", retry=None)
    _arm("dispatch", at=1)
    with pytest.raises(jf.TransientFault) as je:
        js.map_reduce(js.distribute(x), _jsq, "sum", jnp.zeros((8,), jnp.float32))
    with pytest.raises(tf.TransientFault) as te:
        s.map_reduce(s.distribute(x), _sq, "sum", torch.zeros(8))
    jf.record("fatal", je.value)  # the test is the supervisor here
    tf.record("fatal", te.value)
    _same_ledger(fatal=1)


# -- engine degradation -------------------------------------------------------


def test_kernel_fault_degrades_to_eager_no_cache_poisoning():
    x = np.arange(64, dtype=np.float32)
    js, s = _jsess(), _sess()
    jsrc, src = js.distribute(x), s.distribute(x)
    jref = js.map_reduce(jsrc, _jsq, "sum", jnp.zeros((8,), jnp.float32))
    ref = s.map_reduce(src, _sq, "sum", torch.zeros(8))  # the eager reference

    _arm("kernel.segment", at=1)
    js.map_reduce(jsrc, _jsq, "sum", jnp.zeros((8,), jnp.float32), engine="pallas",
                  return_stats=True)
    out, st = s.map_reduce(src, _sq, "sum", torch.zeros(8), engine="pallas",
                           return_stats=True)
    assert torch.equal(out, ref)
    np.testing.assert_array_equal(_np(out), np.asarray(jref))
    assert st.engine == "eager" and st.degraded_engine == "pallas"
    assert s.stats.degraded_nodes == js.stats.degraded_nodes == 1
    assert s.cache_info()["degraded_nodes"] == 1
    _same_ledger(degraded=1)

    # The identical follow-up: served from the degraded node's own cache
    # entry, no new compile, the provenance still visible.
    compiles0 = s.stats.compiles
    out2, st2 = s.map_reduce(src, _sq, "sum", torch.zeros(8), engine="pallas",
                             return_stats=True)
    assert torch.equal(out2, ref)
    assert s.stats.compiles == compiles0
    assert st2.cache_hits == 1
    assert st2.degraded_engine == "pallas" and st2.engine == "eager"


def test_hash_kernel_fault_degrades_hash_dispatch():
    n = 64
    rows = np.stack([np.arange(n) % 16, np.ones(n)], axis=1).astype(np.float32)
    js, s = _jsess(), _sess()

    def jkv(i, row, emit):
        emit(jnp.asarray(row[0], jnp.int32), row[1])

    def kv(i, row, emit):
        emit(row[0].to(torch.int32), row[1])

    _arm("kernel.hash", at=1)
    jout, jst = js.map_reduce(js.distribute(rows), jkv, "sum",
                              JC.make_dist_hashmap(js.mesh, 128, reducer="sum"),
                              engine="pallas", return_stats=True)
    out, st = s.map_reduce(s.distribute(rows), kv, "sum",
                           s.make_dist_hashmap(128, reducer="sum"), engine="pallas",
                           return_stats=True)
    assert st.degraded_engine == jst.degraded_engine == "pallas" and st.engine == "eager"
    assert out.to_dict() == {k: 4.0 for k in range(16)} == jout.to_dict()
    _same_ledger(degraded=1)


def _jpallas_step(src, engine="pallas"):
    def step(ctx, state):
        def mapper(i, x, emit, env):
            emit(jnp.asarray(x, jnp.int32) % 8, x * env[0])

        s = ctx.map_reduce(src, mapper, "sum", jnp.zeros((8,), jnp.float32),
                           engine=engine, env=state)
        return state * 0.5 + s[:1] * 1e-3

    return step


def _pallas_step(src, engine="pallas"):
    def step(ctx, state):
        def mapper(i, x, emit, env):
            emit(x.to(torch.int32) % 8, x * env[0])

        s = ctx.map_reduce(src, mapper, "sum", torch.zeros(8), engine=engine, env=state)
        return state * 0.5 + s[:1] * 1e-3

    return step


@pytest.mark.parametrize("path", ["per_op", "program", "tuning"])
def test_real_error_propagates_without_degrading(path):
    """The port's own rule: a real error while a kernel node is live
    propagates (per op, in a program, in a tuning candidate), where the
    reference degrades the node and runs again.  Nothing is degraded,
    retried or recorded, and once the error is gone the kernel engine runs
    again."""
    s = _sess()
    src = s.distribute(np.arange(64, dtype=np.float32))
    broken = [True]

    def mapper(i, x, emit):
        if broken[0]:
            raise ValueError("mapper failed")
        emit(x.to(torch.int32) % 8, x)

    def per_op(**kw):
        return s.map_reduce(src, mapper, "sum", torch.zeros(8), engine="pallas",
                            return_stats=True, **kw)

    prog = s.program(lambda ctx, st: st + ctx.map_reduce(
        src, mapper, "sum", torch.zeros(8), engine="pallas"))
    run = {"per_op": lambda: per_op()[0],
           "program": lambda: s.run_loop(prog, torch.zeros(8), max_iters=1)[0],
           "tuning": lambda: per_op(tune=True)[0]}[path]
    with pytest.raises(ValueError, match="mapper failed"):
        run()
    assert s.stats.degraded_nodes == 0 and s.stats.retries == 0 and not s._degraded
    assert prog.stats.degradations == 0
    broken[0] = False
    out = run()
    want = np.zeros(8)
    np.add.at(want, np.arange(64) % 8, np.arange(64))
    np.testing.assert_array_equal(_np(out), want)
    if path == "per_op":
        assert per_op()[1].engine == "pallas"
    if path == "program":
        assert all(n.engine == "pallas" for n in prog.plan.mapreduce_nodes())
    assert tf.snapshot()["injected_total"] == 0


def test_program_degradation_shows_in_explain():
    x = np.arange(64, dtype=np.float32)
    js, s = _jsess(), _sess()
    jprog = js.program(_jpallas_step(js.distribute(x)))
    prog = s.program(_pallas_step(s.distribute(x)))
    _arm("kernel.segment", at=1)
    jout, _ = js.run_loop(jprog, jnp.ones((1,), jnp.float32), max_iters=4)
    out, _ = s.run_loop(prog, torch.ones(1), max_iters=4)
    assert s.stats.degraded_nodes == js.stats.degraded_nodes == 1
    _same_ledger(degraded=1)
    assert "degraded 'pallas' -> 'eager' (kernel fault)" in s.explain(prog)
    assert prog.stats.degradations == 1
    # The fault fired before the first run, so the whole run was eager:
    # bit-equal to an all-eager program of the same step.
    tf.reset(env=False)
    e = _sess()
    ref, _ = e.run_loop(e.program(_pallas_step(e.distribute(x), "eager")),
                        torch.ones(1), max_iters=4)
    assert torch.equal(out, ref)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-6)


def test_degraded_program_rebuild_is_cached():
    """After a degradation, dispatching the same program again builds
    nothing new (the eager plan is resident)."""
    x = np.arange(64, dtype=np.float32)
    js, s = _jsess(), _sess()
    jprog = js.program(_jpallas_step(js.distribute(x)))
    prog = s.program(_pallas_step(s.distribute(x)))
    _arm("kernel.segment", at=1)
    jout1, _ = js.run_loop(jprog, jnp.ones((1,), jnp.float32), max_iters=2)
    out1, _ = s.run_loop(prog, torch.ones(1), max_iters=2)
    compiles0 = s.stats.program_compiles
    jcompiles0 = js.stats.program_compiles
    jout2, _ = js.run_loop(jprog, jnp.ones((1,), jnp.float32), max_iters=2)
    out2, _ = s.run_loop(prog, torch.ones(1), max_iters=2)
    assert s.stats.program_compiles == compiles0
    assert js.stats.program_compiles == jcompiles0
    assert torch.equal(out1, out2)
    np.testing.assert_allclose(_np(out2), np.asarray(jout2), rtol=1e-6)
    _same_ledger(degraded=1)


# -- overflow escalation ------------------------------------------------------


def _rows(n):
    return np.stack([np.arange(n), np.ones(n)], axis=1).astype(np.float32)


def _jkv(i, row, emit):
    emit(jnp.asarray(row[0], jnp.int32), row[1])


def _kv(i, row, emit):
    emit(row[0].to(torch.int32), row[1])


def _escalate(n, hm_rounds=(), **kw):
    """The same hash op (after ``hm_rounds`` fitting ones) through both
    packages; returns (port out, port stats, JAX out, JAX stats, port
    session)."""
    js, s = _jsess(**kw), _sess(**kw)
    jhm = JC.make_dist_hashmap(js.mesh, 128, reducer="sum")
    hm = s.make_dist_hashmap(128, reducer="sum")
    for m in hm_rounds:
        jhm = js.map_reduce(js.distribute(_rows(m)), _jkv, "sum", jhm)
        hm = s.map_reduce(s.distribute(_rows(m)), _kv, "sum", hm)
        assert hm.total_overflow() == jhm.total_overflow() == 0
    jout, jst = js.map_reduce(js.distribute(_rows(n)), _jkv, "sum", jhm, return_stats=True)
    out, st = s.map_reduce(s.distribute(_rows(n)), _kv, "sum", hm, return_stats=True)
    return out, st, jout, jst, s


def test_overflow_escalates_capacity_to_dict_oracle():
    out, st, jout, _, s = _escalate(300, escalate_overflow=True)  # beyond 128 slots
    assert out.total_overflow() == 0
    assert st.escalations >= 1 and s.stats.escalations == st.escalations
    assert s.cache_info()["escalations"] == st.escalations
    # capacity climbed the cost grid (powers of two)
    assert out.capacity_per_shard > 128
    assert out.capacity_per_shard & (out.capacity_per_shard - 1) == 0
    assert out.to_dict() == {k: 1.0 for k in range(300)} == jout.to_dict()
    _same_ledger()


def test_escalation_preserves_existing_entries():
    """Escalation regrows the original target: entries merged before the
    overflowing op survive, exactly."""
    out, _, jout, _, _ = _escalate(300, hm_rounds=(50,), escalate_overflow=True)
    assert out.total_overflow() == 0
    want = {k: 2.0 for k in range(50)}
    want.update({k: 1.0 for k in range(50, 300)})
    assert out.to_dict() == want == jout.to_dict()
    _same_ledger()


def test_escalation_is_bounded():
    out, st, jout, jst, _ = _escalate(2000, escalate_overflow=True, max_escalations=1)
    # One doubling (128 -> 256) cannot hold 2000 keys: overflow remains,
    # counted, and escalation stopped at the bound.
    assert st.escalations == jst.escalations == 1
    assert out.capacity_per_shard == jout.capacity_per_shard == 256
    assert out.total_overflow() > 0 and jout.total_overflow() > 0
    _same_ledger()


def test_no_escalation_without_opt_in():
    out, st, jout, _, s = _escalate(300)  # escalate_overflow defaults False
    assert st.escalations == 0 and s.stats.host_syncs == 0
    assert out.capacity_per_shard == 128
    assert out.total_overflow() > 0 and jout.total_overflow() > 0  # counted drops
    _same_ledger()


# -- checkpoints and resume ---------------------------------------------------


def _jloop_program(sess):
    src = sess.distribute(np.arange(64, dtype=np.float32))

    def step(ctx, state):
        def mapper(i, x, emit, env):
            emit(jnp.asarray(x, jnp.int32) % 8, x * env[0])

        s = ctx.map_reduce(src, mapper, "sum", jnp.zeros((8,), jnp.float32), env=state)
        return state * 0.9 + s[:1] * 1e-4

    return sess.program(step)


def _loop_program(sess):
    src = sess.distribute(np.arange(64, dtype=np.float32))

    def step(ctx, state):
        def mapper(i, x, emit, env):
            emit(x.to(torch.int32) % 8, x * env[0])

        s = ctx.map_reduce(src, mapper, "sum", torch.zeros(8), env=state)
        return state * 0.9 + s[:1] * 1e-4

    return sess.program(step)


_STREAM_DATA = np.arange(512, dtype=np.float32).reshape(-1, 2)


def _jstream_program(sess):
    src = sess.chunked(_STREAM_DATA, 64)

    def step(ctx, state):
        def mapper(i, x, emit, env):
            emit(jnp.asarray(x[0], jnp.int32) % 4, x[1] * env[0])

        s = ctx.map_reduce(src, mapper, "sum", jnp.zeros((4,), jnp.float32), env=state)
        return state * 0.8 + s[:1] * 1e-5

    return sess.program(step)


def _stream_program(sess):
    src = sess.chunked(_STREAM_DATA, 64)

    def step(ctx, state):
        def mapper(i, x, emit, env):
            emit(x[0].to(torch.int32) % 4, x[1] * env[0])

        s = ctx.map_reduce(src, mapper, "sum", torch.zeros(4), env=state)
        return state * 0.8 + s[:1] * 1e-5

    return sess.program(step)


T1 = torch.ones(1)


def _j1():
    """The JAX programs' first state, made inside the case (on the mesh)."""
    return jnp.ones((1,), jnp.float32)


def test_run_loop_resume_bit_equal(tmp_path):
    s1 = _sess()
    ref, _ = s1.run_loop(_loop_program(s1), T1, max_iters=8, unroll=2)
    j1 = _jsess()
    jref, _ = j1.run_loop(_jloop_program(j1), _j1(), max_iters=8, unroll=2)
    for tag, sess_, prog_, state in (("jax", _jsess, _jloop_program, _j1()),
                                     ("port", _sess, _loop_program, T1)):
        ckpt = str(tmp_path / tag)
        s2 = sess_()
        s2.run_loop(prog_(s2), state, max_iters=4, unroll=2, checkpoint=ckpt,
                    checkpoint_every=2)
        s3 = sess_()
        out, info = s3.run_loop(prog_(s3), state, max_iters=8, unroll=2, checkpoint=ckpt,
                                resume=True)
        assert info.resumed_from == 4 and info.iterations == 4
        if tag == "port":
            assert torch.equal(out, ref)
    np.testing.assert_allclose(_np(ref), np.asarray(jref), rtol=1e-6)
    _same_ledger()


def test_run_loop_resume_requires_checkpoint():
    j, s = _jsess(), _sess()
    with pytest.raises(ValueError):
        j.run_loop(_jloop_program(j), _j1(), max_iters=2, resume=True)
    with pytest.raises(ValueError):
        s.run_loop(_loop_program(s), T1, max_iters=2, resume=True)
    _same_ledger()


def test_mid_stream_crash_resumes_bit_equal(tmp_path):
    """A fatal fault mid-stream kills the run between checkpoints; a fresh
    session resumes from the checkpointed epoch and finishes bit-equal to
    the uninterrupted run."""
    s1, j1 = _sess(), _jsess()
    ref, _ = s1.run_stream(_stream_program(s1), T1, max_epochs=6)
    jref, _ = j1.run_stream(_jstream_program(j1), _j1(), max_epochs=6)
    # 256 rows / 64 a block = 4 blocks an epoch; crash on a dispatch inside
    # epoch 4 (after the epoch-3 checkpoint landed).
    _arm("dispatch", at=3 * 4 + 2, fatal=True)
    j2, s2 = _jsess(), _sess()
    with pytest.raises(jf.FatalFault):
        j2.run_stream(_jstream_program(j2), _j1(), max_epochs=6,
                      checkpoint=str(tmp_path / "jax"), checkpoint_every=1)
    with pytest.raises(tf.FatalFault):
        s2.run_stream(_stream_program(s2), T1, max_epochs=6,
                      checkpoint=str(tmp_path / "port"), checkpoint_every=1)
    _same_ledger(fatal=1)
    tf.reset(env=False)

    s3 = _sess()
    out, info = s3.run_stream(_stream_program(s3), T1, max_epochs=6,
                              checkpoint=str(tmp_path / "port"), resume=True)
    assert info.resumed_from == 3
    assert torch.equal(out, ref)
    np.testing.assert_allclose(_np(out), np.asarray(jref), rtol=1e-6)


def test_resume_with_empty_dir_starts_fresh(tmp_path):
    s0 = _sess()
    ref, _ = s0.run_loop(_loop_program(s0), T1, max_iters=4)
    s = _sess()
    out, info = s.run_loop(_loop_program(s), T1, max_iters=4,
                           checkpoint=str(tmp_path / "empty"), resume=True)
    j = _jsess()
    jout, jinfo = j.run_loop(_jloop_program(j), _j1(), max_iters=4,
                             checkpoint=str(tmp_path / "jempty"), resume=True)
    assert info.resumed_from is None is jinfo.resumed_from and info.iterations == 4
    assert torch.equal(out, ref)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-6)
    _same_ledger()


def test_checkpoint_write_fault_is_retried(tmp_path):
    _arm("checkpoint.write", at=1)
    for tag, sess_, prog_, state in (("jax", _jsess, _jloop_program, _j1()),
                                     ("port", _sess, _loop_program, T1)):
        s = sess_()
        s.run_loop(prog_(s), state, max_iters=4, unroll=2,
                   checkpoint=str(tmp_path / tag), checkpoint_every=2)
    _same_ledger(retried=1)
    # the retried write really landed: a resumed run finds position 4
    s2 = _sess()
    _, info = s2.run_loop(_loop_program(s2), T1, max_iters=4, unroll=2,
                          checkpoint=str(tmp_path / "port"), resume=True)
    assert info.resumed_from == 4 and info.iterations == 0


# -- prefetch and tuning supervisors ------------------------------------------


def test_prefetch_read_fault_retried_in_worker():
    data = np.arange(512, dtype=np.float32)
    r = _sess()
    ref = r.map_reduce(r.chunked(data, 64), _sq, "sum", torch.zeros(8))
    _arm("prefetch.read", every=3)
    j = _jsess()
    jout = j.map_reduce(j.chunked(data, 64), _jsq, "sum", jnp.zeros((8,), jnp.float32))
    s = _sess()
    out = s.map_reduce(s.chunked(data, 64), _sq, "sum", torch.zeros(8))
    assert torch.equal(out, ref)
    np.testing.assert_array_equal(_np(out), np.asarray(jout))
    _, ts = _same_ledger()
    assert ts["dispositions"]["retried"] >= 1
    assert ts["hits"]["prefetch.read"] == jf.snapshot()["hits"]["prefetch.read"]


def test_tuning_measurement_fault_absorbed():
    x = np.arange(256, dtype=np.float32)
    _arm("tuning.measure", at=1)
    j = _jsess()
    jout = j.map_reduce(j.distribute(x), _jsq, "sum", jnp.zeros((8,), jnp.float32),
                        tune=True)
    s = _sess()
    out = s.map_reduce(s.distribute(x), _sq, "sum", torch.zeros(8), tune=True)
    r = _sess()
    ref = r.map_reduce(r.distribute(x), _sq, "sum", torch.zeros(8))
    # the faulted candidate lost the race; the winner sums integers, exact
    assert torch.equal(out, ref)
    np.testing.assert_array_equal(_np(out), np.asarray(jout))
    assert s.stats.tune_measurements >= 1
    _same_ledger(hits=False, absorbed=1)


def test_corrupt_tuning_json_warns_and_starts_empty(tmp_path):
    path = str(tmp_path / "tuning.json")
    for ctor in (JaxSession, lambda **kw: BlazeSession(device="cpu", **kw)):
        with open(path, "w") as f:
            f.write("{definitely not json")
        with pytest.warns(RuntimeWarning, match="unreadable tuning cache"):
            sess = ctor(tuning_path=path)
        assert sess.tuning.snapshot()["entries"] == 0
        with pytest.warns(RuntimeWarning):
            assert sess.load_tuning(path) == 0
        # the session still works and overwrites the corrupt file atomically
        sess.save_tuning(path)
        with open(path) as f:
            json.load(f)  # valid JSON again
    _same_ledger()


# -- seeded chaos schedules over the algorithms ------------------------------


def test_chaos_streaming_kmeans_bit_equal():
    rng = np.random.RandomState(3)
    pts = rng.randn(1024, 4).astype(np.float32)
    init = pts[:4].copy()

    def run(session):
        return kmeans(session.chunked(pts, 256), 4, init_centers=init, max_iters=6,
                      mode="stream", session=session)

    def jrun(session):
        # the initial centres as an array on the mesh (module docstring)
        return jkmeans(session.chunked(pts, 256), 4, init_centers=jnp.array(init),
                       max_iters=6, mode="stream", session=session)

    ref = run(_sess())
    _arm("dispatch", p=0.2, seed=11)
    _arm("prefetch.read", p=0.1, seed=12)
    jgot = jrun(_jsess())
    got = run(_sess())
    assert np.asarray(got.centers).tobytes() == np.asarray(ref.centers).tobytes()
    np.testing.assert_allclose(got.centers, np.asarray(jgot.centers), atol=1e-4)
    _, ts = _same_ledger()
    assert ts["injected_total"] >= 1  # the schedule really fired
    assert ts["hits"]["prefetch.read"] == jf.snapshot()["hits"]["prefetch.read"]


def test_chaos_pagerank_per_op_bit_equal():
    rng = np.random.RandomState(5)
    edges = rng.randint(0, 64, size=(512, 2)).astype(np.int64)

    ref = pagerank(edges, 64, max_iters=8, session=_sess())
    _arm("dispatch", p=0.15, seed=21)
    _arm("collective", p=0.2, seed=22)
    jgot = jpagerank(edges, 64, max_iters=8, session=_jsess())
    got = pagerank(edges, 64, max_iters=8, session=_sess())
    assert np.asarray(got.scores).tobytes() == np.asarray(ref.scores).tobytes()
    np.testing.assert_allclose(got.scores, np.asarray(jgot.scores), atol=1e-7)
    # A stage whose first run took a collective fault: the reference traces
    # it again on every later call, the port only until a run succeeds.
    js, ts = _same_ledger(hits=False, counts=False)
    assert ts["injected_total"] >= 1 and ts["hits"]["collective"] >= 1
    assert ts["hits"]["collective"] <= js["hits"]["collective"]


@pytest.mark.parametrize("spelling", ("per_op", "program"))
def test_collective_inter_fault_retries_bit_equal_8dev(spelling):
    """``collective.inter`` (the slow inter-node hop of a hierarchical
    reduce) on a (2x4) mesh: an injected transient retries once and the run
    equals the fault-free one bit for bit.  The reference needs eight
    devices for this case, so its side runs in tests/test_torch_multihost.py
    (the same case, per op, against JAX's result and ledger); here the port
    is held to the reference's assertions, per op and in a program."""
    vals = np.random.RandomState(3).randint(0, 100, (64, 4)).astype(np.float32)
    mesh = make_node_data_mesh(2, n_shards=8, device="cpu")

    def run(sess):
        v = sess.distribute(vals)
        if spelling == "per_op":
            return sess.map_reduce(v, _row, "sum", torch.zeros(1, 4))

        def step(ctx, state):
            t = ctx.map_reduce(v, _row, "sum", torch.zeros(1, 4), engine="pallas")
            return {"acc": state["acc"] + t[0]}

        out, _ = sess.run_loop(sess.program(step), {"acc": torch.zeros(4)}, max_iters=3)
        return out["acc"]

    ref = run(_sess(mesh=mesh))
    s = _sess(mesh=mesh)
    tf.configure("collective.inter", at=1)
    got = run(s)
    ts = tf.snapshot()
    assert torch.equal(got, ref)
    assert np.array_equal(_np(got).reshape(-1), (3 if spelling == "program" else 1)
                          * vals.sum(0))
    assert s.stats.retries == 1
    assert ts["balanced"] and ts["dispositions"]["retried"] == 1
    assert ts["injected"] == {"collective.inter": 1}


def _row(i, r, emit):
    emit(0, r)


# -- the carry across a degradation (the port's own) ---------------------------


def test_rediscovery_after_degrade_keeps_the_carry():
    """``degrade()`` drops the plan (and on the card the graphs); the next
    dispatch rediscovers it with the kernel nodes eager and runs on the same
    residual and hash-table tensors, so the run equals one that was eager
    from the start."""
    x = np.arange(64, dtype=np.float32)

    def make(engine):
        s = BlazeSession(device="cpu", n_shards=2, retry=FAST)
        src = s.distribute(x)
        hm = s.make_dist_hashmap(64, reducer="sum")

        def step(ctx, state):
            def kv(i, v, emit):
                emit(v.to(torch.int32) % 16, v)

            def mapper(i, v, emit, env):
                emit(v.to(torch.int32) % 8, v * env[0])

            ctx.map_reduce(src, kv, "sum", hm, engine=engine)
            part = ctx.map_reduce(src, mapper, "sum", torch.zeros(8), engine=engine,
                                  wire="int8", env=state)
            return state * 0.5 + part[:1] * 1e-3

        return s, s.program(step), hm

    s, prog, hm = make("pallas")
    out = prog(T1, 1)
    carry = prog._carry[prog._last_sig]
    ptrs = ([r.data_ptr() for r in carry.residuals],
            [(t.keys.data_ptr(), t.vals.data_ptr(), t.overflow.data_ptr())
             for t in carry.tables.values()])
    assert carry.residuals and carry.tables
    assert prog.degrade() == 2 and prog.degrade() == 0  # no kernel node left
    out = s.supervised(lambda: prog(out, 1), program=prog)
    carry2 = prog._carry[prog._last_sig]
    assert carry2 is carry
    assert ([r.data_ptr() for r in carry2.residuals],
            [(t.keys.data_ptr(), t.vals.data_ptr(), t.overflow.data_ptr())
             for t in carry2.tables.values()]) == ptrs
    assert all(n.engine == "eager" and n.degraded_from == "pallas"
               for n in prog.plan.mapreduce_nodes())

    e, eprog, ehm = make("eager")
    eout = eprog(eprog(T1, 1), 1)
    assert torch.equal(out, eout)
    assert prog.hash_result(hm).to_dict() == eprog.hash_result(ehm).to_dict()
    assert torch.equal(carry2.residuals[0], eprog._carry[eprog._last_sig].residuals[0])


def test_reset_carry_after_degrade_resets_the_kept_carry():
    """``degrade()`` drops the plan but keeps its carry for the
    rediscovery; ``reset_carry()`` resets that carry all the same, as the
    reference's does (its ``degrade`` keeps the plans), so a request the
    server retries after a degradation starts from an empty table."""
    s = _sess()
    src = s.distribute(np.arange(64, dtype=np.float32))
    hm = s.make_dist_hashmap(64, reducer="sum")

    def step(ctx, state):
        def kv(i, v, emit):
            emit(v.to(torch.int32) % 16, v)

        ctx.map_reduce(src, kv, "sum", hm, engine="pallas")
        return state

    prog = s.program(step)
    prog(T1, 1)
    want = prog.hash_result(hm).to_dict()
    assert prog.degrade() == 1
    prog.reset_carry()
    prog(T1, 1)
    got = prog.hash_result(hm).to_dict()
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


# -- serving under faults --------------------------------------------------------


def _server(package, **kw):
    """The reference's server or the port's, on a fast-retry session."""
    from repro.serve import BlazeServer as JaxServer
    from repro_torch.serve import BlazeServer

    kw.setdefault("max_queue", 64)
    kw.setdefault("per_tenant_inflight", 64)
    if package == "repro":
        return JaxServer(_jsess(), **kw)
    return BlazeServer(_sess(), **kw)


def _servers():
    return _server("repro"), _server("repro_torch")


PI = {"n_samples": 512, "iters": 1}


def test_serve_transient_fault_retries_and_reports():
    jsrv, srv = _servers()
    with jsrv, srv:
        jr0, _ = jsrv.submit_and_wait("t", "pi", PI)
        r0, _ = srv.submit_and_wait("t", "pi", PI)
        # hits count only while armed: each server's next dispatch is hit 1
        _arm("dispatch", at=1)
        jr1, _ = jsrv.submit_and_wait("t", "pi", PI)
        r1, _ = srv.submit_and_wait("t", "pi", PI)
        snaps = (jsrv.stats_snapshot(), srv.stats_snapshot())
    assert r1["pi"] == r0["pi"] == jr1["pi"] == jr0["pi"]
    np.testing.assert_array_equal(r1["counts"], np.asarray(jr1["counts"]))
    for snap in snaps:
        rec = snap["recovery"]
        assert rec["retried_batches"] == 1 and rec["balanced"]
        assert rec["dispositions"]["retried"] == 1
        assert snap["completed"] == 2 and snap["failed"] == 0
    _same_ledger(retried=1)


def test_serve_kernel_fault_degrades_and_keeps_serving():
    jsrv, srv = _servers()
    q = {**PI, "engine": "pallas"}
    with jsrv, srv:
        _arm("kernel.segment", at=1)
        out = []
        for server in (jsrv, srv):
            r1, _ = server.submit_and_wait("t", "pi", q)
            # follow-up identical query: answered from the degraded program,
            # zero new program compiles
            compiles0 = server.session.stats.program_compiles
            r2, m2 = server.submit_and_wait("t", "pi", q)
            assert server.session.stats.program_compiles == compiles0
            assert m2["cache"] == "hit"
            out.append((r1, r2, server.stats_snapshot()))
    (jr1, jr2, jsnap), (r1, r2, snap) = out
    assert r2["pi"] == r1["pi"] == jr1["pi"] == jr2["pi"]
    for s in (jsnap, snap):
        rec = s["recovery"]
        assert rec["degraded_batches"] == 1 and rec["balanced"]
        assert rec["session_degraded_nodes"] == 1
        assert s["completed"] == 2
    _same_ledger(degraded=1)


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_serve_shutdown_drains_with_typed_shutdown(package):
    srv = _server(package, max_batch=4)
    srv.start()
    srv.pause_dispatch()  # hold the backlog so stop() must drain it
    reqs = [srv.submit("t", "pi", PI) for _ in range(5)]
    srv.stop(drain_timeout=2.0)
    for req in reqs:
        assert req.done.is_set()
        assert req.error is not None and req.error.code == "SHUTDOWN"
    snap = srv.stats.snapshot()
    # conservation after drain: nothing is left queued or unaccounted
    assert snap["queued"] == 0
    assert snap["submitted"] == snap["completed"] + snap["failed"] == 5
    # stop() is idempotent
    srv.stop()
