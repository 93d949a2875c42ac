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


# The CUDA kernel's design in plain PyTorch (csrc/hash_combine.cu): each CTA
# pre-combines the lanes of its tile, then the probe rounds run over the
# compacted partials, each carrying the count of raw lanes it stands for.
WARP = 32


def _fold(a, b, reducer):
    if reducer == "sum":
        return a + b
    if reducer == "prod":
        return a * b
    return torch.minimum(a, b) if reducer == "min" else torch.maximum(a, b)


def hash_aggregate_tiled(keys, vals, cap, *, reducer="sum", init=None, max_probes=16,
                         ctas=3, bits=THK.MAX_TABLE_BITS):
    """The kernel's arithmetic: ``ctas`` tiles of consecutive lanes, each
    walked by 8 warps of 32 lanes in steps of 256; in a warp's step the live
    lanes that share a key fold into one group.  A warp keeps its hot key
    (the key of the largest group of the first step with a group of two or
    more, for rows of at most 4 values) with its partial and lane count
    aside; any other group folds into the tile's first-come table of
    ``2^bits`` slots (slot ``hash32(key) >> (32 − bits)``, up to
    ``CTA_PROBES`` linear probes; ``bits < 0``: no table) or, finding no
    room, passes through as a partial of the group's size.  At the end the
    hot partials join the table (or pass through), and the table's slots
    follow as partials.  Then round-synchronous probe rounds over the
    partials (the largest key claims a free slot), and ``overflow`` adds the
    sizes of the partials left."""
    from repro_torch.kernels.hash_combine import _initial_table

    tkeys, tvals, ovf = _initial_table(keys, vals, cap, reducer, init)
    acc = tvals.dtype
    vals = vals.to(acc)
    n, v = vals.shape
    tile = -(-n // ctas)
    pk, pv, pm = [], [], []  # the partials: key, row, raw lanes
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        slots = 0 if bits < 0 else 1 << bits
        tags = [THK.EMPTY_KEY] * slots
        part = [None] * slots
        mult = [0] * slots
        hot = [[None, None, 0] for _ in range(8)]  # a warp's hot key, partial, lanes

        def place(key, row, size):
            home = (int(THK.hash32(torch.tensor([key]))) >> (32 - bits)) if bits > 0 else 0
            for p in range(THK.CTA_PROBES if slots else 0):
                s = (home + p) % slots
                if tags[s] == THK.EMPTY_KEY:
                    tags[s] = key
                if tags[s] == key:
                    part[s] = row if part[s] is None else _fold(part[s], row, reducer)
                    mult[s] += size
                    return
            pk.append(key), pv.append(row), pm.append(size)

        for base in range(lo, hi, 8 * WARP):
            for w in range(8):
                groups: dict[int, list[int]] = {}
                for i in range(base + WARP * w, min(base + WARP * (w + 1), hi)):
                    if int(keys[i]) != THK.EMPTY_KEY:
                        groups.setdefault(int(keys[i]), []).append(i)
                if v <= 4 and hot[w][0] is None:
                    big = max((len(lanes) for lanes in groups.values()), default=0)
                    if big > 1:  # the first group of that size, by its first lane
                        hot[w][0] = min((lanes[0], k) for k, lanes in groups.items()
                                        if len(lanes) == big)[1]
                for key, lanes in sorted(groups.items(), key=lambda kv: kv[1][0]):
                    row = vals[lanes[0]]
                    for i in lanes[1:]:
                        row = _fold(row, vals[i], reducer)
                    if key == hot[w][0]:
                        hot[w][1] = row if hot[w][1] is None else _fold(hot[w][1], row, reducer)
                        hot[w][2] += len(lanes)
                    else:
                        place(key, row, len(lanes))
        for key, row, size in hot:
            if key is not None:
                place(key, row, size)
        for s in range(slots):
            if tags[s] != THK.EMPTY_KEY:
                pk.append(tags[s]), pv.append(part[s]), pm.append(mult[s])
    pkeys = torch.tensor(pk, dtype=torch.int32)
    prows = torch.stack(pv) if pv else vals[:0]
    pmult = torch.tensor(pm, dtype=torch.int64)
    home = THK.hash32(pkeys) % cap
    live = torch.arange(len(pk))
    for r in range(max_probes):
        if live.numel() == 0:
            break
        slot = (home[live] + r) % cap
        want = tkeys[slot] == THK.EMPTY_KEY
        claim = torch.full_like(tkeys, THK.EMPTY_KEY).scatter_reduce_(
            0, slot[want], pkeys[live][want], reduce="amax", include_self=True)
        tkeys = torch.where(claim != THK.EMPTY_KEY, claim, tkeys)
        dep = tkeys[slot] == pkeys[live]
        for i, s in zip(live[dep].tolist(), slot[dep].tolist()):
            tvals[s] = _fold(tvals[s], prows[i], reducer)
        live = live[~dep]
    return tkeys, tvals, ovf + int(pmult[live].sum())


@pytest.mark.parametrize("bits", [-1, 2, 12])
@pytest.mark.parametrize("dtype_name", ("f32", "i32"))
@pytest.mark.parametrize("reducer", REDUCERS)
def test_hash_aggregate_tiled_matches_jax_kernel_as_dict(reducer, dtype_name, bits):
    """Pre-combine then rounds, with no CTA table, a 4-slot one (most groups
    pass through) and the kernel's 4,096 slots, against JAX's kernel
    (interpret mode) by key, on hot keys beside rare ones; 2-wide rows keep
    a hot key per warp."""
    rng = np.random.RandomState(13)
    n = 600
    keys = np.where(rng.rand(n) < 0.3, 7, rng.randint(0, 90, n)).astype(np.int32)
    keys[rng.rand(n) < 0.2] = JC.EMPTY_KEY
    vals = _vals(rng, reducer, (n, 2))
    jk, jv, jo = JHK.hash_aggregate(
        jnp.asarray(keys), jnp.asarray(vals).astype(JDT[dtype_name]), 256,
        reducer=reducer, block_n=64, interpret=True)
    tk, tv, to = hash_aggregate_tiled(
        torch.from_numpy(keys), torch.from_numpy(vals).to(TDT[dtype_name]), 256,
        reducer=reducer, bits=bits)
    assert int(to) == int(jo) == 0
    want, got = _table_dict(jk, jv), _table_dict(tk.numpy(), tv.numpy())
    assert set(got) == set(want)
    for key in want:
        _assert_agree(np.array(got[key]), np.array(want[key]), reducer,
                      dtype_name, abs_sum=np.full(2, 8.0 * n))


@pytest.mark.parametrize("bits", [-1, 1, 12])
@pytest.mark.parametrize("reducer", ("sum", "max"))
def test_hash_aggregate_tiled_equals_unique_insert_slot_for_slot(reducer, bits):
    """Pre-combining keeps the set of keys and their probe sequences: the
    table equals hashmap_insert of the unique keys, slot for slot, as the
    plain version's does, with an init= table holding keys already."""
    rng = np.random.RandomState(17)
    keys = torch.from_numpy(np.where(rng.rand(700) < 0.25, 5,
                                     rng.randint(-400, 400, 700)).astype(np.int32))
    vals = torch.from_numpy(rng.randint(-9, 10, (700, 1)).astype(np.int32))
    red = get_reducer(reducer)
    first = THK.hash_aggregate(keys[:100], vals[:100], 1024, reducer=reducer, max_probes=16)
    got = hash_aggregate_tiled(keys, vals, 1024, reducer=reducer, init=first, bits=bits)
    want = THK.hash_aggregate_plain(keys, vals, 1024, reducer=reducer, init=first,
                                    max_probes=16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    uk, uv, um = TC.unique_combine(keys, vals[:, 0], torch.ones(700, dtype=torch.bool), red)
    table = TC.HashTable(first[0].clone(), first[1][:, 0].clone(), first[2].clone())
    ref = TC.hashmap_insert(table, uk, uv, um, red)
    np.testing.assert_array_equal(got[0].numpy(), ref.keys.numpy())
    np.testing.assert_array_equal(got[1][:, 0].numpy(), ref.vals.numpy())


@pytest.mark.parametrize("bits", [-1, 2, 12])
def test_hash_aggregate_tiled_overflow_counts_raw_lanes(bits):
    """64 distinct keys × 5 shuffled copies into 16 slots, 16 probes: 48 keys
    find no slot, 240 raw lanes, whatever the partials group (JAX's kernel
    and the plain version count the same)."""
    rng = np.random.RandomState(0)
    keys = rng.permutation(np.repeat(np.arange(64, dtype=np.int32), 5))
    vals = np.ones((320, 1), np.int32)
    _, _, jo = JHK.hash_aggregate(jnp.asarray(keys), jnp.asarray(vals), 16,
                                  max_probes=16, interpret=True)
    tk, tv, to = hash_aggregate_tiled(torch.from_numpy(keys), torch.from_numpy(vals), 16,
                                      max_probes=16, bits=bits)
    _, _, po = THK.hash_aggregate_plain(torch.from_numpy(keys), torch.from_numpy(vals),
                                        16, max_probes=16)
    assert int(to) == int(jo) == int(po) == 240
    assert all(v == (5.0,) for v in _table_dict(tk.numpy(), tv.numpy()).values())


@pytest.mark.parametrize("v,bits", [(1, 12), (2, 11), (9, 10), (4094, 1), (12_286, 0),
                                    (12_287, -1)])
def test_hash_aggregate_table_bits_is_a_pure_function(v, bits):
    """The CTA table: the most slots (at most 4,096) of a tag, a count and
    ``v`` 4-byte partials within 48 KiB; none when one slot does not fit."""
    assert THK.table_bits(v) == bits
    if bits >= 0:
        assert (8 + 4 * v) << bits <= THK.TABLE_BYTES
        assert bits == THK.MAX_TABLE_BITS or (8 + 4 * v) << (bits + 1) > THK.TABLE_BYTES
