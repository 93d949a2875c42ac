"""The port's kernel modules against the JAX package's Pallas kernels (run in
interpret mode on the CPU, as the JAX tests run them).

On CPU tensors the wrappers take their plain PyTorch versions, which are what
runs here; ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the CUDA
kernels against those plain versions on the card.

Tolerances: integer results and min/max are exact; a float sum or product
may differ by ``rtol=1e-5`` plus ``1e-5`` of the sum of its addends'
magnitudes, because the two packages sum in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import containers as JC
from repro.core.reducers import get_reducer as jget_reducer
from repro.kernels import hash_combine as JHK
from repro.kernels.segment_reduce import segment_reduce as jsegment_reduce
from repro_torch.core import containers as TC
from repro_torch.core.reducers import get_reducer
from repro_torch.kernels import hash_combine as THK
from repro_torch.kernels.segment_reduce import (
    identity,
    segment_reduce,
    segment_reduce_plain,
)

REDUCERS = ("sum", "prod", "min", "max")
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16, "i32": jnp.int32}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int32}


def _vals(rng, reducer, shape):
    if reducer == "prod":
        vals = rng.choice([1.0, -1.0], shape)
        vals[rng.rand(*shape) < 0.1] = 2.0
        return vals
    return rng.randint(-8, 9, shape).astype(np.float64)


def _assert_agree(got, want, reducer, dtype_name, abs_sum=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if dtype_name == "i32" or reducer in ("min", "max"):
        np.testing.assert_array_equal(got, want)
    else:
        atol = 1e-5 * (abs_sum if abs_sum is not None else np.abs(want))
        assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + atol)


def _jax_bf16_as_f32(vals, dtype_name):
    """Values as the kernels see them: bf16 rounds once, both packages."""
    return np.asarray(jnp.asarray(vals).astype(JDT[dtype_name]), np.float64)


@pytest.mark.parametrize("dtype_name", ("f32", "bf16", "i32"))
@pytest.mark.parametrize("reducer", REDUCERS)
def test_segment_reduce_matches_jax_kernel(reducer, dtype_name):
    """ids outside [0, K) dropped (their NaN never read), 3-wide rows."""
    rng = np.random.RandomState(7)
    n, k, v = 200, 16, 3
    ids = rng.randint(-3, k + 3, n).astype(np.int32)
    vals = _vals(rng, reducer, (n, v))
    if dtype_name != "i32":
        vals[ids < 0, 0] = np.nan  # dropped lanes only
    want = jsegment_reduce(jnp.asarray(ids), jnp.asarray(vals).astype(JDT[dtype_name]),
                           k, reducer=reducer, interpret=True)
    got = segment_reduce(torch.from_numpy(ids),
                         torch.from_numpy(vals).to(TDT[dtype_name]), k,
                         reducer=reducer)
    assert got.dtype == (torch.int32 if dtype_name == "i32" else torch.float32)
    seen = _jax_bf16_as_f32(np.nan_to_num(vals), dtype_name)
    keep = (ids >= 0) & (ids < k)
    abs_sum = np.zeros((k, v))
    np.add.at(abs_sum, ids[keep], np.abs(seen[keep]))
    _assert_agree(got.numpy(), want, reducer, dtype_name, abs_sum)


@pytest.mark.parametrize("reducer", REDUCERS)
def test_segment_reduce_empty_stream_is_identity(reducer):
    for dtype_name in ("f32", "i32"):
        want = jsegment_reduce(jnp.zeros((0,), jnp.int32),
                               jnp.zeros((0, 2), JDT[dtype_name]), 5,
                               reducer=reducer, interpret=True)
        got = segment_reduce(torch.zeros(0, dtype=torch.int32),
                             torch.zeros((0, 2), dtype=TDT[dtype_name]), 5,
                             reducer=reducer)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segment_reduce_plain_float_sum_accumulates_beyond_f32_steps():
    """2^25 ones on one key: an f32 running sum stalls at 2^24; the plain
    version's float64 accumulation counts them all."""
    ids = torch.zeros(1 << 25, dtype=torch.int32)
    out = segment_reduce_plain(ids, torch.ones((1 << 25, 1)), 1)
    assert out.dtype == torch.float32 and float(out[0, 0]) == 2.0**25


def test_segment_reduce_rejects_bad_input():
    with pytest.raises(ValueError, match="unknown reducer"):
        segment_reduce(torch.zeros(2, dtype=torch.int32), torch.zeros(2, 1), 3,
                       reducer="mean")
    with pytest.raises(ValueError, match="need ids"):
        segment_reduce(torch.zeros(3, dtype=torch.int32), torch.zeros(2, 1), 3)


def _table_dict(tk, tv):
    tk, tv = np.asarray(tk), np.asarray(tv, np.float64)
    return {int(k): tuple(tv[i]) for i, k in enumerate(tk) if k != JC.EMPTY_KEY}


@pytest.mark.parametrize("dtype_name", ("f32", "i32", "bf16"))
@pytest.mark.parametrize("reducer", REDUCERS)
def test_hash_aggregate_matches_jax_kernel_as_dict(reducer, dtype_name):
    """Same keys, values and overflow; the slot layouts differ (the TPU
    kernel claims block by block), so the comparison is by key."""
    rng = np.random.RandomState(3)
    n = 257
    keys = rng.randint(0, 60, n).astype(np.int32)
    vals = _vals(rng, reducer, (n, 2))
    keys[rng.rand(n) < 0.25] = JC.EMPTY_KEY  # dead lanes
    jk, jv, jo = JHK.hash_aggregate(
        jnp.asarray(keys), jnp.asarray(vals).astype(JDT[dtype_name]), 256,
        reducer=reducer, block_n=64, interpret=True,
    )
    tk, tv, to = THK.hash_aggregate(
        torch.from_numpy(keys), torch.from_numpy(vals).to(TDT[dtype_name]), 256,
        reducer=reducer,
    )
    assert int(to) == int(jo) == 0
    want, got = _table_dict(jk, jv), _table_dict(tk.numpy(), tv.numpy())
    assert set(got) == set(want)
    for key in want:
        _assert_agree(np.array(got[key]), np.array(want[key]), reducer,
                      dtype_name, abs_sum=np.full(2, 8.0 * n))


@pytest.mark.parametrize("reducer", ("sum", "min"))
def test_hash_aggregate_init_merge_matches_jax_kernel(reducer):
    rng = np.random.RandomState(5)
    ka, kb = rng.randint(0, 40, 100).astype(np.int32), rng.randint(0, 40, 80).astype(np.int32)
    va = rng.randint(-9, 10, (100, 1)).astype(np.float32)
    vb = rng.randint(-9, 10, (80, 1)).astype(np.float32)
    ja = JHK.hash_aggregate(jnp.asarray(ka), jnp.asarray(va), 128,
                            reducer=reducer, interpret=True)
    jm = JHK.hash_aggregate(jnp.asarray(kb), jnp.asarray(vb), 128,
                            reducer=reducer, init=ja, interpret=True)
    ta = THK.hash_aggregate(torch.from_numpy(ka), torch.from_numpy(va), 128,
                            reducer=reducer)
    tm = THK.hash_aggregate(torch.from_numpy(kb), torch.from_numpy(vb), 128,
                            reducer=reducer, init=ta)
    assert int(tm[2]) == int(jm[2]) == 0
    assert _table_dict(tm[0].numpy(), tm[1].numpy()) == _table_dict(jm[0], jm[1])


def test_hash_aggregate_overflow_counted_like_jax():
    keys = np.arange(64, dtype=np.int32)
    vals = np.full((64, 1), 3.0, np.float32)
    jk, jv, jo = JHK.hash_aggregate(jnp.asarray(keys), jnp.asarray(vals), 16,
                                    max_probes=16, interpret=True)
    tk, tv, to = THK.hash_aggregate(torch.from_numpy(keys), torch.from_numpy(vals),
                                    16, max_probes=16)
    assert int(to) == int(jo) == 48
    assert all(v == (3.0,) for v in _table_dict(tk.numpy(), tv.numpy()).values())


def test_hash_aggregate_matches_hashmap_insert_layout():
    """A unique batch lands every key in the slot JAX's hashmap_insert (and
    the port's) puts it: the same probe sequence and claim tie-break."""
    rng = np.random.RandomState(0)
    cap = 64
    keys = np.unique(rng.randint(0, 10_000, 80).astype(np.int32))[:40]
    vals = np.arange(len(keys), dtype=np.float32) + 1.0
    jred = jget_reducer("sum")
    ref = JC.hashmap_insert(JC.make_table(cap, (), jnp.float32, jred),
                            jnp.asarray(keys), jnp.asarray(vals),
                            jnp.ones(len(keys), bool), jred)
    tk, tv, to = THK.hash_aggregate(torch.from_numpy(keys),
                                    torch.from_numpy(vals[:, None]), cap,
                                    max_probes=16)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(ref.keys))
    np.testing.assert_array_equal(tv[:, 0].numpy(), np.asarray(ref.vals))
    assert int(to) == int(ref.overflow)


@pytest.mark.parametrize("reducer", REDUCERS)
def test_hash_aggregate_with_duplicates_equals_unique_insert(reducer):
    """Duplicates fold in the probe rounds: the table equals hashmap_insert
    of the pre-combined unique keys, slot for slot."""
    rng = np.random.RandomState(11)
    keys = torch.from_numpy(rng.randint(-500, 500, 600).astype(np.int32))
    vals = torch.from_numpy(_vals(rng, reducer, (600,)).astype(np.float32))
    red = get_reducer(reducer)
    tk, tv, to = THK.hash_aggregate(keys, vals[:, None], 1024, reducer=reducer,
                                    max_probes=16)
    uk, uv, um = TC.unique_combine(keys, vals, torch.ones(600, dtype=torch.bool), red)
    ref = TC.hashmap_insert(TC.make_table(1024, (), torch.float32, red, "cpu"),
                            uk, uv, um, red)
    np.testing.assert_array_equal(tk.numpy(), ref.keys.numpy())
    np.testing.assert_array_equal(tv[:, 0].numpy(), ref.vals.numpy())
    assert int(to) == int(ref.overflow) == 0


def test_hash32_kernel_copy_is_the_containers_hash():
    assert THK.EMPTY_KEY == TC.EMPTY_KEY == JHK.EMPTY_KEY
    assert THK.hash32 is TC.hash32
    assert identity("min", torch.int32) == np.iinfo(np.int32).max


@pytest.mark.parametrize("n,v,k,sms,form,blocks", [
    (100_000_000, 4, 5, 132, "registers", 264),  # k-means' [x | 1] -> [5, 4]
    (50_000_000, 9, 5, 132, "registers", 270),  # GMM op 5 -> [5, 9]
    (16_777_216, 1, 1 << 20, 132, "global", 1056),  # PageRank -> [2^20, 1]
    (5000, 3, 8, 132, "registers", 15),  # the register form's key limit
    (5000, 3, 9, 132, "shared", 20),  # one key past it
    (5000, 3, 4096, 132, "shared", 20),  # [4096, 3] f32 fits 48 KiB
    (5000, 3, 4097, 132, "global", 20),
    (10, 9, 2, 132, "registers", 9),  # a grid of whole columns, however small
    (100_000_000, 9, 5, 100, "registers", 207),
    (301, 12_289, 1, 132, "global", 2),  # one row past 48 KiB: global, with no table
])
def test_segment_reduce_launch_shape_is_a_pure_function(n, v, k, sms, form, blocks):
    """The form and grid follow from (N, V, K, SM count) alone; the register
    form's grid keeps each thread's 4 slots on fixed columns (4·256·blocks a
    multiple of V)."""
    from repro_torch.kernels.segment_reduce import SLOTS, THREADS, launch_shape

    assert launch_shape(n, v, k, sms) == (form, blocks)
    if form == "registers":
        assert SLOTS * THREADS * blocks % v == 0
