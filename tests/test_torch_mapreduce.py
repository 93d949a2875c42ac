"""The port's ``map_reduce`` against the JAX package's, engine by engine, on
the same numpy pair streams (negative ids, masked lanes, keys >= K), at one
shard.  Mirrors the cells of ``test_engines_differential.py`` and
``test_hash_differential.py`` that fit a few seconds each.

Tolerances: the pair values are small integers (and prod values are +-1 or
2), so every partial sum and product is exactly representable in f32, bf16
and i32 alike; the results are then equal, and float sums are still only
held to ``rtol=1e-5`` plus ``1e-5`` of the sum of magnitudes per key (the
summation order differs).  ``MapReduceStats`` counts (pairs emitted and
shipped, shuffle bytes, overflow) are equal; the ``kernel_*`` geometry fields
describe each package's own launch and are not compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlazeSession as JaxSession
from repro.core import DistRange as JDistRange
from repro.core import custom_reducer as jcustom_reducer
from repro.core import distribute as jdistribute
from repro.core import make_dist_hashmap as jmake_dist_hashmap
from repro_torch.core import (
    BlazeSession,
    DistRange,
    custom_reducer,
    get_default_session,
    get_reducer,
    map_reduce,
    reset_default_session,
    set_default_session,
)
from repro_torch.core.cost import PALLAS_AUTO_MAX_KEYS

REDUCERS = ("sum", "min", "max", "prod")
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "i32": jnp.int32}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}
N_PAIRS = 64

JSESS = JaxSession()
SESS = BlazeSession(device="cpu")


def _jmapper(i, row, emit):
    emit(row[0].astype(jnp.int32), row[1], mask=row[2] > 0)


def _tmapper(i, row, emit):
    emit(row[0].to(torch.int32), row[1], mask=row[2] > 0)


def _rows(reducer, key_range, seed=0):
    rng = np.random.RandomState(seed + key_range)
    keys = rng.randint(-2, key_range + 2, N_PAIRS).astype(np.float32)
    if reducer == "prod":
        vals = rng.choice([1.0, -1.0], N_PAIRS).astype(np.float32)
        vals[rng.rand(N_PAIRS) < 0.15] = 2.0
    else:
        vals = rng.randint(-8, 9, N_PAIRS).astype(np.float32)
    mask = (rng.rand(N_PAIRS) > 0.2).astype(np.float32)
    return np.stack([keys, vals, mask], axis=1)


def _identity(reducer, dtype_name):
    return get_reducer(reducer).identity(TDT[dtype_name])


def _run_dense(rows, reducer, dtype_name, key_range, engine):
    ident = _identity(reducer, dtype_name)
    jout, jst = JSESS.map_reduce(
        jdistribute(rows), _jmapper, reducer,
        jnp.full((key_range,), ident, JDT[dtype_name]), engine=engine,
        return_stats=True,
    )
    tout, tst = SESS.map_reduce(
        SESS.distribute(rows), _tmapper, reducer,
        torch.full((key_range,), ident, dtype=TDT[dtype_name]), engine=engine,
        return_stats=True,
    )
    return np.asarray(jout, np.float64), tout, jst.finalize(), tst.finalize()


def _assert_stats_equal(jst, tst):
    assert tst.engine == jst.engine
    assert tst.collective == jst.collective
    for field in ("pairs_emitted", "pairs_shipped", "shuffle_payload_bytes",
                  "overflow"):
        assert getattr(tst, field) == getattr(jst, field), field


CELLS = [(e, r, d, 8) for e in ("eager", "naive", "pallas") for r in REDUCERS
         for d in ("f32", "bf16", "i32")]
CELLS += [(e, "sum", d, k) for e in ("eager", "naive", "pallas")
          for d in ("f32", "i32") for k in (1, 1000)]


@pytest.mark.parametrize("engine,reducer,dtype_name,key_range", CELLS)
def test_dense_engine_matches_jax(engine, reducer, dtype_name, key_range):
    rows = _rows(reducer, key_range)
    want, got, jst, tst = _run_dense(rows, reducer, dtype_name, key_range, engine)
    assert got.dtype == TDT[dtype_name]
    got = got.double().numpy()
    if dtype_name == "i32" or reducer != "sum":
        np.testing.assert_array_equal(got, want)
    else:
        keys, vals, mask = rows.T
        live = (mask > 0) & (keys >= 0) & (keys < key_range)
        abs_sum = np.zeros(key_range)
        np.add.at(abs_sum, keys[live].astype(np.int64), np.abs(vals[live]))
        assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5 * abs_sum)
    _assert_stats_equal(jst, tst)


@pytest.mark.parametrize("engine", ("eager", "naive", "pallas"))
def test_empty_shard_and_dropped_lanes(engine):
    """All lanes masked → the target comes back unchanged; a NaN or inf on a
    masked lane never reaches any key; ids outside [0, K) are dropped."""
    masked = np.stack([np.arange(N_PAIRS) % 8, np.ones(N_PAIRS),
                       np.zeros(N_PAIRS)], 1).astype(np.float32)
    target = torch.full((8,), float("inf"))
    out = SESS.map_reduce(SESS.distribute(masked), _tmapper, "min", target,
                          engine=engine)
    assert torch.equal(out, target)
    nan_rows = np.array([[0, 1, 1], [1, np.nan, 0], [2, 2, 1], [3, np.inf, 0],
                         [8, 7, 1], [-1, 7, 1]], np.float32)
    out = SESS.map_reduce(SESS.distribute(nan_rows), _tmapper, "sum",
                          torch.zeros(4), engine=engine)
    np.testing.assert_array_equal(out.numpy(), [1.0, 0.0, 2.0, 0.0])


def _static_mapper_j(i, row, emit):
    emit(0, row[1])
    emit(3, row[1] * 2, mask=row[2] > 0)
    emit(row[0].astype(jnp.int32), 1.0)


def _static_mapper_t(i, row, emit):
    emit(0, row[1])
    emit(3, row[1] * 2, mask=row[2] > 0)
    emit(row[0].to(torch.int32), 1.0)


@pytest.mark.parametrize("engine", ("eager", "pallas", "naive"))
def test_static_keys_mixed_with_dynamic_match_jax(engine):
    rows = _rows("sum", 6, seed=4)
    jout = JSESS.map_reduce(jdistribute(rows), _static_mapper_j, "max",
                            jnp.full((6,), -jnp.inf), engine=engine)
    tout = SESS.map_reduce(SESS.distribute(rows), _static_mapper_t, "max",
                           torch.full((6,), float("-inf")), engine=engine)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def _range_mapper_j(v, emit):
    emit(v % 5, v * 1.5)


def _range_mapper_t(v, emit):
    emit(v % 5, v * 1.5)


def test_range_source_and_custom_reducer_match_jax():
    """A DistRange source; a custom reducer runs the eager plan under every
    engine request, with its sort + segmented-scan combine."""
    jred = jcustom_reducer("maxish", jnp.maximum, lambda dt: jnp.asarray(-jnp.inf, dt))
    tred = custom_reducer("maxish", torch.maximum, lambda dt: float("-inf"))
    # key 4 falls outside the [4] target and is dropped
    jout = JSESS.map_reduce(JDistRange(3, 200, 7), _range_mapper_j, jred,
                            jnp.full((4,), -jnp.inf))
    for engine in ("eager", "pallas", "auto"):
        tout, st = SESS.map_reduce(DistRange(3, 200, 7), _range_mapper_t, tred,
                                   torch.full((4,), float("-inf")),
                                   engine=engine, return_stats=True)
        assert st.engine == "eager"
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    rows = _rows("max", 20, seed=9)
    jhm = JSESS.map_reduce(jdistribute(rows), _jmapper, jred,
                           jmake_dist_hashmap(JSESS.mesh, 64, (), jnp.float32, jred))
    thm = SESS.map_reduce(SESS.distribute(rows), _tmapper, tred,
                          SESS.make_dist_hashmap(64, (), torch.float32, tred),
                          engine="pallas")
    np.testing.assert_array_equal(thm.table.keys.numpy(), np.asarray(jhm.table.keys))
    np.testing.assert_array_equal(thm.table.vals.numpy(), np.asarray(jhm.table.vals))


def _hist_mapper_j(key, count, emit):
    emit(jnp.minimum(count, 15).astype(jnp.int32), 1)


def _hist_mapper_t(key, count, emit):
    emit(torch.clamp(count, max=15).to(torch.int32), 1)


@pytest.mark.parametrize("engine", ("eager", "pallas", "naive"))
def test_hash_map_source_matches_jax(engine):
    """A DistHashMap as the source: a histogram of word counts read from a
    counts table (free slots are masked out of the mapper's lanes)."""
    rng = np.random.RandomState(8)
    words = rng.zipf(1.5, 400).clip(max=90).astype(np.int32)

    def count_j(i, w, emit):
        emit(w, 1)

    def count_t(i, w, emit):
        emit(w, 1)

    jhm = JSESS.map_reduce(jdistribute(words), count_j, "sum",
                           jmake_dist_hashmap(JSESS.mesh, 256, (), jnp.int32, "sum"))
    thm = SESS.map_reduce(SESS.distribute(words), count_t, "sum",
                          SESS.make_dist_hashmap(256, (), torch.int32, "sum"),
                          engine=engine)
    jhist = JSESS.map_reduce(jhm, _hist_mapper_j, "sum", jnp.zeros((16,), jnp.int32),
                             engine=engine)
    thist = SESS.map_reduce(thm, _hist_mapper_t, "sum",
                            torch.zeros(16, dtype=torch.int32), engine=engine)
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))


def _run_hash(rows, reducer, engine, cap, jengine=None, key_range=None):
    jhm, jst = JSESS.map_reduce(
        jdistribute(rows), _jmapper, reducer,
        jmake_dist_hashmap(JSESS.mesh, cap, (), jnp.float32, reducer),
        engine=jengine or engine, return_stats=True, key_range=key_range,
    )
    thm, tst = SESS.map_reduce(
        SESS.distribute(rows), _tmapper, reducer,
        SESS.make_dist_hashmap(cap, (), torch.float32, reducer),
        engine=engine, return_stats=True, key_range=key_range,
    )
    return jhm, thm, jst.finalize(), tst.finalize()


@pytest.mark.parametrize("reducer", REDUCERS)
@pytest.mark.parametrize("engine", ("eager", "pallas", "naive"))
def test_hash_target_matches_jax(engine, reducer):
    """Every port engine's table equals JAX eager's slot for slot (no
    overflow here); against the same JAX engine, equal as a dict with equal
    stats."""
    rows = _rows(reducer, 50, seed=7)
    jeager, thm, _, _ = _run_hash(rows, reducer, engine, 256, jengine="eager")
    np.testing.assert_array_equal(thm.table.keys.numpy(), np.asarray(jeager.table.keys))
    np.testing.assert_array_equal(thm.table.vals.numpy(), np.asarray(jeager.table.vals))
    jhm, thm, jst, tst = _run_hash(rows, reducer, engine, 256)
    assert {k: float(v) for k, v in thm.to_dict().items()} == \
        {int(k): float(v) for k, v in jhm.to_dict().items()}
    _assert_stats_equal(jst, tst)
    if engine == "pallas":
        assert tst.kernel_table_cap is not None and tst.kernel_probe_depth >= 16
        assert 0.0 < tst.kernel_occupancy <= 1.0


@pytest.mark.parametrize("engine", ("eager", "pallas", "naive"))
def test_hash_overflow_counted_like_jax(engine):
    """96 distinct keys into 16 slots: the same overflow, never silent."""
    rows = np.stack([np.arange(96), np.full(96, 2.0), np.ones(96)], 1).astype(np.float32)
    jhm, thm, jst, tst = _run_hash(rows, "sum", engine, 16)
    assert thm.total_overflow() == jhm.total_overflow() == 80
    assert thm.size() == 16
    assert all(float(v) == 2.0 for v in thm.to_dict().values())
    _assert_stats_equal(jst, tst)


@pytest.mark.parametrize("key_range,engine", [(100, "eager"), (1000, "pallas"),
                                              (None, "pallas")])
def test_key_range_narrows_the_wire_like_jax(key_range, engine):
    rng = np.random.RandomState(3)
    rows = np.stack([rng.randint(0, 100, 128), rng.randint(-4, 5, 128),
                     np.ones(128)], 1).astype(np.float32)
    jhm, thm, jst, tst = _run_hash(rows, "sum", engine, 4096, key_range=key_range)
    _assert_stats_equal(jst, tst)
    if engine == "eager":
        np.testing.assert_array_equal(thm.table.keys.numpy(),
                                      np.asarray(jhm.table.keys))
    assert {k: float(v) for k, v in thm.to_dict().items()} == \
        {int(k): float(v) for k, v in jhm.to_dict().items()}


def _dyn_mapper(i, x, emit):
    emit(x[0].to(torch.int32), x[1])


def test_auto_engine_and_stage_cache():
    sess = BlazeSession(device="cpu")
    rows = torch.tensor(_rows("sum", 8)[:, :2]).abs()
    pts = sess.distribute(rows.numpy())
    t8 = torch.zeros(8)
    for i in range(10):
        _, st = sess.map_reduce(pts, _dyn_mapper, "sum", t8, engine="pallas",
                                return_stats=True)
        assert (st.compiles, st.cache_hits) == ((1, 0) if i == 0 else (0, 1))
    _, st = sess.map_reduce(pts, _dyn_mapper, "sum", t8, engine="auto",
                            return_stats=True)
    assert st.engine == "pallas" and st.compiles == 0 and st.cache_hits == 1
    _, st = sess.map_reduce(pts, _dyn_mapper, "sum",
                            torch.zeros(PALLAS_AUTO_MAX_KEYS + 1), engine="auto",
                            return_stats=True)
    assert st.engine == "eager" and st.compiles == 1
    big = sess.make_dist_hashmap(8192)
    _, st = sess.map_reduce(pts, _dyn_mapper, "sum", big, engine="auto",
                            return_stats=True)
    assert st.engine == "eager"
    assert sess.cache_info()["entries"] == 3 and sess.stats.calls == 13
    with pytest.raises(ValueError, match="unknown engine"):
        sess.map_reduce(pts, _dyn_mapper, "sum", t8, engine="spark")


def test_later_slices_raise_not_implemented(monkeypatch):
    # tune=True, the in-process (node, data) mesh, the mesh across processes
    # and streams across processes are ported (tests/test_torch_tuning.py,
    # tests/test_torch_multihost.py, tests/test_torch_multiprocess.py,
    # tests/test_torch_multiprocess_stream.py).  On a mesh of two processes,
    # as rank 1 sees it (no collective runs here): chunked(mesh=) keeps this
    # rank's rows of every block, and a chunked vector made without the
    # mesh (the global rows) is refused rather than counted twice.
    from repro_torch.core import containers as C

    two = C.Mesh(2, 4, torch.device("cpu"), group=object(), rank=1, n_ranks=2)
    sess = BlazeSession(mesh=two)
    x = np.arange(64, dtype=np.float32)
    cv = sess.chunked(x, 16)
    assert (cv.n_blocks, cv.block_rows, cv.local_rows, cv.mesh) == (4, 16, 8, two)
    for b in range(cv.n_blocks):
        # shards 4..7 of the block: its second half
        np.testing.assert_array_equal(cv.block_host(b), x[b * 16 + 8:(b + 1) * 16])
        assert cv.block_base(b) == int(cv.block_view(b).base) == b * 16 + 8
    C.require_rank_rows(two, cv, "cv")
    one = C.chunked(x, 16, 8, "cpu")
    with pytest.raises(ValueError, match="not this rank's"):
        sess.map_reduce(one, _tmapper, "sum", torch.zeros(4))


def test_free_map_reduce_uses_the_default_session():
    sess = BlazeSession(device="cpu")
    prev = set_default_session(sess)
    try:
        out = map_reduce(DistRange(0, 10, 1), _range_mapper_t, "sum", torch.zeros(5))
        assert get_default_session() is sess and sess.stats.calls == 1
        np.testing.assert_array_equal(out.numpy(), [7.5, 10.5, 13.5, 16.5, 19.5])
    finally:
        reset_default_session()
        if prev is not None:
            set_default_session(prev)
