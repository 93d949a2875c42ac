"""The port's tuning half of ``core/cost.py`` against the reference's
(``tests/test_cost.py``'s measurement-grid and cache tests): the candidate
shapes, ``key_range`` gating the pinning of K2's capacity, a config's
identity excluding its outcomes, the cache's counters and its round trip.

The grids are re-based on the port's kernels: a dense node's candidates are
K1's valid launch forms at several CTAs an SM, a hash node's K2's table
capacity, probe depth and table of hot keys.  So the tests hold the shapes
and the gating to the reference's, and the grids themselves to the kernels'
own launch rules (every form valid for its shape, the register form's grid a
multiple of its step).  Exact comparisons throughout: nothing here sums
floats.
"""
import json
import math
import warnings

import jax.numpy as jnp
import pytest
import torch

from repro.core import cost as jcost
from repro_torch.core import cost
from repro_torch.kernels import hash_combine as HK
from repro_torch.kernels import segment_reduce as SR

# (k, v): k-means' [5, 4] and program [5, 5], GMM's [5, 9], the register
# form's key limit, one past it, a shared-only key range, PageRank's 2^20
# keys, and rows too wide for a shared copy of 8 keys.
DENSE_SHAPES = [(5, 4), (5, 5), (5, 9), (8, 6), (9, 4), (64, 4), (1 << 20, 1), (8, 2000)]


@pytest.mark.parametrize("k,v", DENSE_SHAPES)
def test_dense_tuning_candidates_shape(k, v):
    cands = cost.dense_tuning_candidates(k, v, "sum", torch.float32)
    # the reference's shape: eager first, then distinct kernel configs
    jcands = jcost.dense_tuning_candidates(min(k, 4096), v, "sum", jnp.float32)
    assert cands[0] == cost.TunedConfig(engine="eager") and jcands[0].engine == "eager"
    kernel = cands[1:]
    assert all(c.engine == "pallas" and c.form and c.ctas_per_sm for c in kernel)
    assert len({(c.form, c.ctas_per_sm) for c in kernel}) == len(kernel)
    # re-based: each valid form of K1 at every measured CTA count, no other
    forms = SR.valid_forms(k, v)
    assert {c.form for c in kernel} == set(forms)
    assert [c.ctas_per_sm for c in kernel] == list(cost.TUNE_CTAS_PER_SM) * len(forms)
    fits = k * v * 4 <= SR.SHARED_BYTES
    assert ("registers" in forms) == (fits and k <= SR.REG_K)
    assert ("shared" in forms) == fits and "global" in forms


@pytest.mark.parametrize("k,v", DENSE_SHAPES)
@pytest.mark.parametrize("n", [1, 777, 5003, 100_000_000])
def test_dense_candidates_launch_as_the_kernel_takes_them(k, v, n):
    """Every candidate is a launch the C entry accepts: the register form's
    grid a multiple of its step (so 4 * blocks * THREADS divides by v), and
    no grid above the candidate's CTAs an SM (past the step's rounding)."""
    for sms in (1, 132):
        for c in cost.dense_tuning_candidates(k, v, "sum", torch.float32)[1:]:
            form, blocks = SR.launch_shape(n, v, k, sms, form=c.form,
                                           ctas_per_sm=c.ctas_per_sm)
            assert form == c.form and blocks >= 1
            if form == "registers":
                step = v // math.gcd(v, SR.SLOTS * SR.THREADS)
                assert blocks % step == 0
                assert (SR.SLOTS * blocks * SR.THREADS) % v == 0
                assert blocks <= max(step, -(-sms * c.ctas_per_sm // step) * step)
            else:
                assert blocks <= sms * c.ctas_per_sm


def test_default_launch_is_unchanged_by_the_overrides():
    for k, v in DENSE_SHAPES:
        for n in (1, 5003, 10**8):
            assert SR.launch_shape(n, v, k, 132) == SR.launch_shape(
                n, v, k, 132, form=None, ctas_per_sm=None)
            form, _ = SR.launch_shape(n, v, k, 132)
            assert form == SR.valid_forms(k, v)[0]
            assert SR.launch_shape(n, v, k, 132) == SR.launch_shape(
                n, v, k, 132, form=form, ctas_per_sm=SR.CTAS_PER_SM[form])


def test_invalid_overrides_raise_and_never_fall_back():
    ids = torch.zeros(8, dtype=torch.int32)
    vals = torch.ones((8, 2))
    with pytest.raises(ValueError, match="not valid"):
        SR.segment_reduce(ids, vals, 9, form="registers")  # 9 keys > REG_K
    with pytest.raises(ValueError, match="not valid"):
        SR.segment_reduce(ids, torch.ones((8, 13_000)), 1, form="shared")
    with pytest.raises(ValueError, match="not valid"):
        SR.launch_shape(8, 2, 9, 132, form="warp")
    with pytest.raises(ValueError, match="ctas_per_sm"):
        SR.segment_reduce(ids, vals, 4, ctas_per_sm=0)
    keys = torch.arange(8, dtype=torch.int32)
    bits = HK.table_bits(2)
    for bad in (bits + 1, -2):
        with pytest.raises(ValueError, match="table_bits"):
            HK.hash_aggregate(keys, vals, 16, table_bits=bad)
    # valid overrides run (the CPU's plain versions ignore the launch shape)
    want = SR.segment_reduce(ids, vals, 4)
    assert torch.equal(SR.segment_reduce(ids, vals, 4, form="global", ctas_per_sm=1), want)
    out = HK.hash_aggregate(keys, vals, 16, table_bits=-1)
    for a, b in zip(out, HK.hash_aggregate(keys, vals, 16)):
        assert torch.equal(a, b)


def test_hash_tuning_candidates_key_range_gates_cap_pinning():
    # without key_range capacity must follow the runtime n: engine-only, as
    # in the reference
    cands = cost.hash_tuning_candidates(1, "sum", torch.int32, key_range=None)
    jcands = jcost.hash_tuning_candidates(1, "sum", jnp.int32, key_range=None)
    assert [c.engine for c in cands] == [c.engine for c in jcands] == ["eager", "pallas"]
    assert cands[1].table_cap is None and cands[1].table_bits is None
    # with key_range, (cap, probes, bits) are pinned, cap >= 2x the bound
    for key_range, v in ((50, 1), (40, 1), (1 << 19, 1), (3000, 4), (100, 2000)):
        cands = cost.hash_tuning_candidates(v, "sum", torch.int32, key_range=key_range)
        assert cands[0].engine == "eager"
        bound = 1 << (key_range - 1).bit_length()
        default_bits = HK.table_bits(v)
        caps = set()
        for c in cands[1:]:
            assert c.engine == "pallas"
            assert c.table_cap & (c.table_cap - 1) == 0
            assert cost.MIN_TABLE_CAP <= c.table_cap <= cost.MAX_TABLE_CAP
            assert c.table_cap >= min(2 * key_range, cost.MAX_TABLE_CAP)
            assert c.table_cap >= cost.table_capacity(1 << 30, key_range) or \
                c.table_cap == cost.MAX_TABLE_CAP
            assert c.probe_depth == cost.choose_probe_depth(1 << 30, c.table_cap)
            assert c.table_bits in {default_bits, default_bits - 2, -1}
            assert -1 <= c.table_bits <= default_bits
            caps.add(c.table_cap)
        assert caps == {min(max(m * bound, cost.MIN_TABLE_CAP), cost.MAX_TABLE_CAP)
                        for m in (2, 4, 8)}
        assert len({(c.table_cap, c.table_bits) for c in cands[1:]}) == len(cands) - 1


def test_tuned_config_identity_excludes_outcomes():
    a = cost.TunedConfig(engine="pallas", form="shared", ctas_per_sm=4)
    b = cost.TunedConfig(engine="pallas", form="shared", ctas_per_sm=4,
                         source="measured", wall_s=0.5)
    assert a == b and hash(a) == hash(b)
    assert a != cost.TunedConfig(engine="pallas", form="shared", ctas_per_sm=2)
    rt = cost.TunedConfig.from_dict(b.to_dict())
    assert rt == b and rt.source == "measured" and rt.wall_s == 0.5
    # the reference's field names carry over where their meaning does
    jb = jcost.TunedConfig(engine="pallas", table_cap=256, probe_depth=64,
                           source="measured", wall_s=0.5)
    shared = {"engine", "table_cap", "probe_depth", "source", "wall_s"}
    assert shared <= set(b.to_dict()) and shared <= set(jb.to_dict())
    assert "block_n" not in b.to_dict()
    h = cost.TunedConfig(engine="pallas", table_cap=256, probe_depth=64, table_bits=-1)
    assert h.describe() == "pallas cap=256 probes=64 bits=-1"
    assert {k: v for k, v in h.to_dict().items() if k in shared} == \
        {k: v for k, v in jb.to_dict().items() if k in shared} | {"source": "fallback",
                                                                  "wall_s": None}


def test_tuning_cache_counters_and_roundtrip(tmp_path):
    c = cost.TuningCache()
    assert c.get("x") is None and c.misses == 1
    cfg = cost.TunedConfig(engine="pallas", form="registers", ctas_per_sm=2,
                           source="measured", wall_s=0.01)
    c.put("x", cfg)
    assert c.get("x") == cfg and c.hits == 1
    assert c.peek("y") is None and c.misses == 1  # peek never counts
    c.record_measurements(3)
    snap = c.snapshot()
    assert snap["entries"] == 1 and snap["measurements"] == 3
    p = tmp_path / "tuning.json"
    c.save(str(p))
    assert [q.name for q in tmp_path.iterdir()] == ["tuning.json"]  # no temp left
    c2 = cost.TuningCache()
    assert c2.load(str(p)) == 1
    got = c2.peek("x")
    assert got == cfg and got.source == "measured" and got.wall_s == 0.01
    assert json.loads(p.read_text())["version"] == 1


@pytest.mark.parametrize("content", ["{\"entries\": {\"x\": {\"engin", "[1, 2]", ""])
def test_tuning_cache_load_warns_on_a_corrupt_file(tmp_path, content):
    p = tmp_path / "tuning.json"
    p.write_text(content)
    c = cost.TuningCache()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert c.load(str(p)) == 0
    assert any(issubclass(x.category, RuntimeWarning) for x in w)
    assert len(c) == 0
    with pytest.warns(RuntimeWarning):
        assert c.load(str(tmp_path / "missing.json")) == 0


def test_auto_crossover_is_unchanged():
    # PALLAS_AUTO_MAX_KEYS stays the reference's until it is measured on the
    # card (the EXPLAIN goldens resolve engine="auto" with it)
    assert cost.PALLAS_AUTO_MAX_KEYS == jcost.PALLAS_AUTO_MAX_KEYS == 4096
    for k in (0, 1, 4096, 4097, 1 << 20):
        assert cost.pick_engine(k) == jcost.pick_engine(k)
