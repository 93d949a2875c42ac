"""Property-based tests (hypothesis) of the port's containers: the mirror of
the container half of ``tests/test_property.py`` on
``repro_torch.core.containers`` on the CPU, with that file's
``settings(max_examples=40, deadline=None)``.

Each test holds the port to the reference test's oracle (a dict, a sort)
and to JAX's function on the same drawn input:

* ``unique_combine`` against dict semantics for sum, min and max: integer
  values and min/max exactly; f32 sums within the reference's ``1e-4``
  (the oracle adds in input order, the scan in its own); against JAX the
  same output slots, keys and validity, and the values bit for bit (both
  fold each run with the same log-step segmented scan);
* ``hashmap_insert`` against a dict (no overflow when the keys fit), and
  slot for slot equal to JAX's table, overflow included, whether or not
  the keys fit (round-synchronous probing with the max-key claim);
* ``bucket_by_dest``: nothing dropped at capacity ``n``, every valid
  ``(key, value)`` pair in exactly one bucket (so the values are conserved
  exactly, stronger than the reference's ``1e-4`` on the sum), and the
  buckets equal JAX's;
* ``topk`` against a sort, and against JAX's ``topk``: raw values (the
  rows are the values, so exact), and rows scored by a column with many
  ties, where the rows that tie on a score must come back as JAX's do.
"""
import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    import hypothesis  # noqa: F401
except ImportError as e:
    if os.environ.get("REQUIRE_HYPOTHESIS"):
        raise ImportError(
            "REQUIRE_HYPOTHESIS is set but hypothesis failed to import — "
            "the property suite must run, not skip, in CI"
        ) from e
    pytest.skip("hypothesis not installed", allow_module_level=True)
from hypothesis import example, given, settings, strategies as st

from repro.core import containers as JC
from repro.core import distribute as jdistribute
from repro.core import topk as jtopk
from repro.core.mapreduce import bucket_by_dest as jbucket_by_dest
from repro.core.reducers import custom_reducer as jcustom_reducer
from repro.core.reducers import get_reducer as jget_reducer
from repro_torch.core import containers as TC
from repro_torch.core.mapreduce import bucket_by_dest
from repro_torch.core.reducers import custom_reducer, get_reducer, segmented_scan

SMALL = settings(max_examples=40, deadline=None)
# JAX's side, one compiled program a drawn shape rather than one per op
_jbucket_by_dest = jax.jit(jbucket_by_dest, static_argnums=(3, 4, 5))
_junique_combine = jax.jit(JC.unique_combine, static_argnums=(3,))
_jhashmap_insert = jax.jit(JC.hashmap_insert, static_argnums=(4,),
                           static_argnames=("max_probes",))
_COMBINE = {"sum": lambda a, b: a + b, "min": min, "max": max}


@SMALL
@given(
    st.lists(st.integers(min_value=0, max_value=30), min_size=1, max_size=100),
    st.sampled_from(["sum", "min", "max"]),
    st.sampled_from(["f32", "i32"]),
)
@example(keys=[0, 0, 1, 0], red_name="sum", dtype="f32")
def test_unique_combine_equals_dict_semantics(keys, red_name, dtype):
    rng = np.random.RandomState(42)
    if dtype == "f32":
        vals = rng.rand(len(keys)).astype(np.float32)
    else:
        vals = rng.randint(-50, 50, len(keys)).astype(np.int32)
    k = np.asarray(keys, np.int32)
    mask = np.ones(len(keys), bool)
    ok, ov, valid = TC.unique_combine(torch.from_numpy(k), torch.from_numpy(vals),
                                      torch.from_numpy(mask), get_reducer(red_name))
    got = {int(a): b.item() for a, b, m in zip(ok, ov, valid) if m}
    want: dict = {}
    for kk, vv in zip(keys, vals.tolist()):
        want[kk] = _COMBINE[red_name](want[kk], vv) if kk in want else vv
    assert set(got) == set(want)
    for kk in want:
        if dtype == "f32" and red_name == "sum":
            assert abs(got[kk] - want[kk]) < 1e-4
        else:
            assert got[kk] == want[kk]
    jk, jv, jm = _junique_combine(jnp.asarray(k), jnp.asarray(vals), jnp.asarray(mask),
                                  jget_reducer(red_name))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jv))


# -- the segmented scan in the reference's order -------------------------------

_SCAN_LENGTHS = (1, 2, 3, 4, 7, 8, 33, 64, 127, 128, 199, 200)
_TORCH_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}
_JAX_COMBINE = {"sum": jnp.add, "min": jnp.minimum, "max": jnp.maximum}
_IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}


def _jsegmented_scan(red_name):
    """The segmented scan of the reference's ``unique_combine``:
    ``jax.lax.associative_scan`` over ``(values, run starts)``."""
    combine = _JAX_COMBINE[red_name]

    def op(a, b):
        av, af = a
        bv, bf = b
        bcast = bf.reshape(bf.shape + (1,) * (av.ndim - bf.ndim))
        return jnp.where(bcast, bv, combine(av, bv)), af | bf

    return jax.jit(lambda v, s: jax.lax.associative_scan(op, (v, s), axis=0)[0])


@pytest.mark.parametrize("tail", [(), (3,)], ids=["1d", "n_by_3"])
@pytest.mark.parametrize("red_name", ["sum", "min", "max"])
@pytest.mark.parametrize("what", ["segmented_scan", "custom_segment"])
def test_segmented_scan_is_jax_associative_scan_bit_for_bit(what, red_name, tail):
    """``segmented_scan`` against ``jax.lax.associative_scan`` of the
    segmented operator, and ``custom_reducer``'s segment against the
    reference's, bit for bit on f32 values, odd and even lengths from 1 to
    200.  The reference's custom segment broadcasts its run flags against
    the values' last axis, so ``[n, 3]`` values are held against it column
    by column (each column is its own 1-D segment, as it is in the port)."""
    rng = np.random.RandomState(len(tail) * 10 + len(red_name))
    jscan = _jsegmented_scan(red_name)
    tred = custom_reducer(red_name, _TORCH_COMBINE[red_name],
                          lambda dt, r=red_name: _IDENTITY[r])
    jred = jcustom_reducer(red_name, _JAX_COMBINE[red_name],
                           lambda dt, r=red_name: jnp.asarray(_IDENTITY[r], dt))
    jsegment = jax.jit(jred.segment, static_argnums=(2,))
    for n in _SCAN_LENGTHS:
        vals = rng.randn(n, *tail).astype(np.float32)
        if what == "segmented_scan":
            starts = rng.rand(n) < 0.25
            starts[0] = True
            got = segmented_scan(torch.from_numpy(vals), torch.from_numpy(starts),
                                 _TORCH_COMBINE[red_name]).numpy()
            want = np.asarray(jscan(vals, starts))
        else:
            ids = rng.randint(0, max(1, n // 3), n).astype(np.int32)
            k = int(ids.max()) + 1
            got = tred.segment(torch.from_numpy(vals), torch.from_numpy(ids), k).numpy()
            cols = vals.reshape(n, -1).T
            want = np.stack([np.asarray(jsegment(c, ids, k)) for c in cols], -1)
            want = want.reshape((k,) + tail)
        assert got.dtype == want.dtype and got.shape == want.shape, n
        assert got.tobytes() == want.tobytes(), f"n={n}"


@SMALL
@given(
    st.lists(st.integers(min_value=0, max_value=1000), min_size=1, max_size=80,
             unique=True),
    st.integers(min_value=4, max_value=8),
)
def test_hashmap_insert_equals_dict(keys, logcap):
    cap = 2**logcap
    k = np.asarray(keys, np.int32)
    red, jred = get_reducer("sum"), jget_reducer("sum")
    t = TC.hashmap_insert(TC.make_table(cap, (), torch.float32, red, device="cpu"),
                          torch.from_numpy(k), torch.ones(len(keys)),
                          torch.ones(len(keys), dtype=torch.bool), red, max_probes=cap)
    live = {int(a): float(b) for a, b in zip(t.keys, t.vals) if a != TC.EMPTY_KEY}
    if len(keys) <= cap:
        assert int(t.overflow) == 0
        assert live == {kk: 1.0 for kk in keys}
    jt = _jhashmap_insert(JC.make_table(cap, (), jnp.float32, jred), jnp.asarray(k),
                          jnp.ones((len(keys),), jnp.float32), jnp.ones(len(keys), bool),
                          jred, max_probes=cap)
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(jt.keys))
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(jt.vals))
    assert int(t.overflow) == int(jt.overflow)


@SMALL
@given(
    st.integers(min_value=1, max_value=64),
    st.integers(min_value=1, max_value=8),
)
def test_bucket_by_dest_conserves_pairs(n, n_dest):
    rng = np.random.RandomState(n * 7 + n_dest)
    keys = rng.randint(0, 1000, n).astype(np.int32)
    vals = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) > 0.3
    cap = n  # enough for everything
    bk, bv, dropped = bucket_by_dest(torch.from_numpy(keys), torch.from_numpy(vals),
                                     torch.from_numpy(valid), n_dest, cap, 0.0)
    assert int(dropped) == 0
    live = bk.numpy().reshape(-1) != TC.EMPTY_KEY
    assert live.sum() == valid.sum()
    got = collections.Counter(zip(bk.numpy().reshape(-1)[live].tolist(),
                                  bv.numpy().reshape(-1)[live].tolist()))
    assert got == collections.Counter(zip(keys[valid].tolist(), vals[valid].tolist()))
    jk, jv, jd = _jbucket_by_dest(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid),
                                 n_dest, cap, 0.0)
    np.testing.assert_array_equal(bk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(bv.numpy(), np.asarray(jv))
    assert int(dropped) == int(jd)


def _first_column(x):
    return x[0]


def _jfirst_column(x):
    return x[0]


@SMALL
@given(st.integers(min_value=2, max_value=100), st.integers(min_value=1, max_value=20))
def test_topk_matches_sort(n, k):
    rng = np.random.RandomState(n * 31 + k)
    x = rng.randn(n).astype(np.float32)
    got = TC.topk(TC.distribute(x, device="cpu"), min(k, n))
    want = np.sort(x)[::-1][: min(k, n)]
    np.testing.assert_array_equal(np.sort(got)[::-1], want)
    np.testing.assert_array_equal(got, np.asarray(jtopk(jdistribute(x), min(k, n))))
    # Scores with ties (a handful of integer values), rows told apart by
    # their index: the rows of a tied score must come back in JAX's order.
    rows = np.stack([rng.randint(0, 5, n), np.arange(n)], 1).astype(np.float32)
    got = TC.topk(TC.distribute(rows, device="cpu"), min(k, n), _first_column)
    want = np.asarray(jtopk(jdistribute(rows), min(k, n), _jfirst_column))
    np.testing.assert_array_equal(got[:, 0], np.sort(rows[:, 0])[::-1][: min(k, n)])
    np.testing.assert_array_equal(got, want)
