"""The port's containers against the JAX package's, on the same numpy inputs:
hashing and key ownership bit for bit, the eager local combine, the
round-synchronous hash insert slot for slot, destination bucketing (drops
included), ``DistRange`` partitioning, the synthetic datasets, and carrying
containers across packages with ``repro_torch.convert``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlazeSession as JaxSession
from repro.core import containers as JC
from repro.core import distribute as jdistribute
from repro.core import make_dist_hashmap as jmake_dist_hashmap
from repro.core.mapreduce import bucket_by_dest as jbucket_by_dest
from repro.core.reducers import get_reducer as jget_reducer
from repro.data import synthetic as jsynthetic
from repro_torch import convert
from repro_torch.core import BlazeSession
from repro_torch.core import containers as TC
from repro_torch.core.mapreduce import bucket_by_dest
from repro_torch.core.reducers import custom_reducer, get_reducer
from repro_torch.data import synthetic as tsynthetic

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
SPECIAL_KEYS = np.array([0, 1, -1, INT32_MIN, INT32_MAX, INT32_MIN + 1], np.int32)


def _keys(n=4096, seed=0):
    rng = np.random.RandomState(seed)
    return np.concatenate(
        [SPECIAL_KEYS, rng.randint(INT32_MIN, INT32_MAX, n, dtype=np.int64)]
    ).astype(np.int32)


def test_hash32_bit_equal_to_jax():
    xs = _keys()
    want = np.asarray(JC.hash32(jnp.asarray(xs))).astype(np.int64)
    got = TC.hash32(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_shards", (1, 3, 4, 8))
def test_shard_of_key_bit_equal_to_jax(n_shards):
    xs = _keys(seed=n_shards)
    want = np.asarray(JC.shard_of_key(jnp.asarray(xs), n_shards)).astype(np.int64)
    got = TC.shard_of_key(torch.from_numpy(xs), n_shards).numpy()
    np.testing.assert_array_equal(got, want)


def _pairs(n, n_keys, reducer, seed):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, n_keys, n).astype(np.int32)
    if reducer == "prod":
        vals = rng.choice([1.0, -1.0, 2.0], n, p=[0.45, 0.45, 0.1])
    else:
        vals = rng.randint(-8, 9, n).astype(np.float64)
    mask = rng.rand(n) > 0.2
    return keys, vals, mask


@pytest.mark.parametrize("dtype", ("f32", "i32"))
@pytest.mark.parametrize("reducer", ("sum", "prod", "min", "max"))
def test_unique_combine_matches_jax(reducer, dtype):
    """Same output positions, keys and validity; values exact (integer-valued
    inputs keep every partial result exact in both dtypes)."""
    keys, vals, mask = _pairs(200, 30, reducer, seed=1)
    np_dt = np.float32 if dtype == "f32" else np.int32
    jred = jget_reducer(reducer)
    jk, jv, jm = jax.jit(lambda k, v, m: JC.unique_combine(k, v, m, jred))(
        jnp.asarray(keys), jnp.asarray(vals.astype(np_dt)), jnp.asarray(mask)
    )
    tk, tv, tm = TC.unique_combine(
        torch.from_numpy(keys), torch.from_numpy(vals.astype(np_dt)),
        torch.from_numpy(mask), get_reducer(reducer),
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_unique_combine_custom_reducer_scan():
    """A custom reducer's combine drives the log-step segmented scan."""
    keys, vals, mask = _pairs(300, 17, "max", seed=2)
    red = custom_reducer("maxish", torch.maximum, lambda dt: float("-inf"))
    tk, tv, tm = TC.unique_combine(
        torch.from_numpy(keys), torch.from_numpy(vals.astype(np.float32)),
        torch.from_numpy(mask), red,
    )
    want = {}
    for k, v, m in zip(keys.tolist(), vals.tolist(), mask.tolist()):
        if m:
            want[k] = max(want.get(k, -np.inf), v)
    got = {int(k): float(v) for k, v, m in zip(tk, tv, tm) if m}
    assert got == want


def _insert_both(keys, vals, cap, max_probes):
    jred, tred = jget_reducer("sum"), get_reducer("sum")
    jt = JC.hashmap_insert(
        JC.make_table(cap, (), jnp.float32, jred), jnp.asarray(keys),
        jnp.asarray(vals), jnp.ones(len(keys), bool), jred, max_probes=max_probes,
    )
    tt = TC.hashmap_insert(
        TC.make_table(cap, (), torch.float32, tred, device="cpu"),
        torch.from_numpy(keys), torch.from_numpy(vals),
        torch.ones(len(keys), dtype=torch.bool), tred, max_probes=max_probes,
    )
    return jt, tt


@pytest.mark.parametrize("n_keys,cap,max_probes", [(40, 64, 16), (64, 16, 16),
                                                   (500, 1024, 4)])
def test_hashmap_insert_layout_matches_jax(n_keys, cap, max_probes):
    """Round-synchronous probing with the max-key claim places every key in
    the same slot, and counts the same overflow, in both packages."""
    rng = np.random.RandomState(n_keys)
    keys = rng.choice(np.arange(-50_000, 50_000), n_keys, replace=False).astype(np.int32)
    vals = np.arange(n_keys, dtype=np.float32) + 1.0
    jt, tt = _insert_both(keys, vals, cap, max_probes)
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    np.testing.assert_array_equal(tt.vals.numpy(), np.asarray(jt.vals))
    assert int(tt.overflow) == int(jt.overflow)


@pytest.mark.parametrize("n_dest,cap", [(1, 8), (4, 4), (4, 64), (3, 2)])
def test_bucket_by_dest_matches_jax(n_dest, cap):
    """Stable bucketing: same buffers and the same drop count, including
    full buckets that keep their first-emitted pairs."""
    rng = np.random.RandomState(n_dest * 100 + cap)
    n = 40
    keys = rng.randint(0, 25, n).astype(np.int32)
    vals = np.arange(n, dtype=np.float32)  # emission-order tag
    valid = rng.rand(n) > 0.1
    jk, jv, jd = jbucket_by_dest(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid), n_dest, cap, 0.0
    )
    tk, tv, td = bucket_by_dest(
        torch.from_numpy(keys), torch.from_numpy(vals), torch.from_numpy(valid),
        n_dest, cap, 0.0,
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(td) == int(jd)


@pytest.mark.parametrize("n_shards", (1, 3, 4))
def test_dist_range_local_values_match_jax(n_shards):
    rng = TC.DistRange(5, 47, 3)
    jrng = JC.DistRange(5, 47, 3)
    vals, valid = rng.local_values(torch.arange(n_shards), n_shards)
    for s in range(n_shards):
        jv, jm = jrng.local_values(jnp.asarray(s), n_shards)
        np.testing.assert_array_equal(vals[s].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(valid[s].numpy(), np.asarray(jm))
    assert len(rng) == len(jrng)


def test_synthetic_data_identical_to_jax_package():
    for name, args in [("zipf_corpus", (16, 8, 100)), ("rmat_edges", (6, 4)),
                       ("cluster_points", (50, 3, 4))]:
        a = getattr(jsynthetic, name)(*args, seed=3)
        b = getattr(tsynthetic, name)(*args, seed=3)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)


def test_distribute_collect_pads_to_shards():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    v = TC.distribute(x, n_shards=4, device="cpu")
    jv = jdistribute(x)
    assert v.data.shape == (8, 2) and len(v) == 5
    np.testing.assert_array_equal(TC.collect(v), x)
    np.testing.assert_array_equal(TC.collect(v), JC.collect(jv))


def test_convert_round_trips():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    v = convert.dist_vector(x, 5, device="cpu")
    data, n = convert.to_numpy(v)
    np.testing.assert_array_equal(data, x)
    assert n == 5
    jhm = jmake_dist_hashmap(JaxSession().mesh, 32, (2,), jnp.bfloat16, "max")
    hm = convert.dist_hashmap(
        np.asarray(jhm.table.keys), np.asarray(jhm.table.vals),
        np.asarray(jhm.table.overflow), jhm.reducer_name, device="cpu",
    )
    assert hm.table.vals.dtype == torch.bfloat16 and hm.reducer_name == "max"
    keys, vals, ovf, name = convert.to_numpy(hm)
    np.testing.assert_array_equal(keys, np.asarray(jhm.table.keys))
    np.testing.assert_array_equal(vals, np.asarray(jhm.table.vals, np.float32))
    np.testing.assert_array_equal(ovf, np.asarray(jhm.table.overflow))
    assert name == "max"
    with pytest.raises(TypeError):
        convert.to_numpy(torch.zeros(3))


@pytest.mark.parametrize("engine", ("eager", "pallas"))
def test_port_merges_into_a_table_built_by_jax(engine):
    """A word-count table built by JAX crosses over with ``convert`` and the
    port merges a second pass into it: the result equals JAX merging the
    same pass into its own table, slot for slot."""
    rng = np.random.RandomState(4)
    first = rng.randint(0, 60, 300).astype(np.int32)
    second = rng.randint(30, 90, 300).astype(np.int32)

    def m(i, w, emit):
        emit(w, 1)

    jsess = JaxSession()
    jhm = jmake_dist_hashmap(jsess.mesh, 256, (), jnp.int32, "sum")
    jhm = jsess.map_reduce(jdistribute(first), m, "sum", jhm, engine="eager")
    jmerged = jsess.map_reduce(jdistribute(second), m, "sum", jhm, engine="eager")
    hm = convert.dist_hashmap(
        np.asarray(jhm.table.keys), np.asarray(jhm.table.vals),
        np.asarray(jhm.table.overflow), jhm.reducer_name, device="cpu",
    )
    sess = BlazeSession(device="cpu")
    merged = sess.map_reduce(sess.distribute(second), m, "sum", hm, engine=engine)
    keys, vals, ovf, _ = convert.to_numpy(merged)
    np.testing.assert_array_equal(keys, np.asarray(jmerged.table.keys))
    np.testing.assert_array_equal(vals, np.asarray(jmerged.table.vals))
    np.testing.assert_array_equal(ovf, np.asarray(jmerged.table.overflow))


def test_entry_points_need_cuda_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlazeSession()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.distribute(np.zeros(4, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.make_dist_hashmap(16)
    assert BlazeSession(device="cpu").device.type == "cpu"


def _row_map(row, env):
    return torch.cat([row * env, row.sum()[None]])


def _jrow_map(row, env):
    return jnp.concatenate([row * env, row.sum()[None]])


@pytest.mark.parametrize("n_shards", (1, 4))
def test_foreach_matches_jax(n_shards):
    """An elementwise map with and without ``env``, same ``n``; padding rows
    (4 shards over 10 rows) are mapped too and cut by ``collect``."""
    x = np.random.RandomState(6).randn(10, 3).astype(np.float32)
    env = np.array([2.0, -1.0, 0.5], np.float32)
    v = TC.distribute(x, n_shards=n_shards, device="cpu")
    jv = jdistribute(x)
    got = TC.foreach(v, _row_map, env=torch.from_numpy(env))
    want = JC.foreach(jv, _jrow_map, env=jnp.asarray(env))
    assert got.n == want.n == 10
    assert got.data.shape == (12 if n_shards == 4 else 10, 4)
    np.testing.assert_allclose(TC.collect(got), JC.collect(want), rtol=1e-6)
    sq = BlazeSession(device="cpu", n_shards=n_shards).foreach(v, lambda r: r * r)
    np.testing.assert_array_equal(TC.collect(sq), x * x)


def _neg_dist(x, q):
    return -torch.sum((x - q) ** 2)


def _jneg_dist(x, q):
    return -jnp.sum((x - q) ** 2)


@pytest.mark.parametrize("n_shards", (1, 4))
def test_topk_matches_jax(n_shards):
    """Distinct scores: the same rows in the same order, by raw values and
    by a score with ``env``; padding rows never enter."""
    rng = np.random.RandomState(8)
    vals = rng.permutation(203).astype(np.float32) - 300.0  # all below the pad 0
    rows = rng.randn(203, 2).astype(np.float32)
    q = np.array([0.3, -0.2], np.float32)
    jmesh = JaxSession().mesh
    got = TC.topk(TC.distribute(vals, n_shards, "cpu"), 7, n_shards=n_shards)
    want = JC.topk(jdistribute(vals), 7, mesh=jmesh)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.sort(vals)[::-1][:7])
    got = TC.topk(TC.distribute(rows, n_shards, "cpu"), 9, _neg_dist,
                  env=torch.from_numpy(q), n_shards=n_shards)
    want = JC.topk(jdistribute(rows), 9, _jneg_dist, mesh=jmesh, env=jnp.asarray(q))
    np.testing.assert_array_equal(got, np.asarray(want))
    sess = BlazeSession(device="cpu", n_shards=n_shards)
    got = sess.topk(sess.distribute(rows), 9, _neg_dist, env=torch.from_numpy(q))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert sess.stats.host_syncs == 1
