"""K4's ``"dh"`` form (``kernels.flash_attention.dh_logits`` and
``dh_softmax_pv``, ``csrc/flash_attention_dh.cu``) on the CPU, where each
wrapper runs its plain version (``kernels.ref.attention_logits`` and
``attention_from_logits``).

* The pair with ``d_head`` split by hand into ``M`` slices (what ``M``
  ranks of the model axis hold), the partial logits summed (the all-reduce)
  and the slices' outputs concatenated, against the reference's
  ``repro.kernels.ops.attention_chunked(..., shard_hint="dh")`` on the whole
  tensors (its ``constrain`` is a no-op outside a mesh): GQA at 1, 2 and 6
  query heads a kv head, one and eight positions, a softcap, a window over
  a cache's view at an offset.  Rows with no live key (query positions
  before the first key) are held to ``attention_ref``'s zeros, not to the
  reference's chunked path, which gives such a row the mean of ``v``
  (``ROADMAP.md`` Queue 3 item 5).
* The custom ops ``blaze::dh_logits`` and ``blaze::dh_softmax_pv``: their
  fake implementations give the real shapes and dtypes, and their flop
  formula what ``FlopCounterMode`` counts for the plain pair.
* The wrappers raise on shapes, dtypes and widths the kernels do not take.
* ``ops.attention(shard_hint="dh")`` on ``DTensor``s (a gloo group of one, a
  (1, 1) mesh): ``impl="ref"``, and any impl on CPU tensors, runs the plain
  pair, counted in ``attention.dh_plain_calls``, and launches nothing.
* The kernels' launch plan (``dh_plan``): ``dh_softmax_pv``'s splits
  covering every live key tile once, ``dh_logits``' runs every item once,
  no CTA empty, the head group and the ring within the shared-memory budget
  (the kernels' own count of it is held equal on the card, in
  ``tests/test_torch_cuda.py``), bulk copies only on the cache's layout.
* ``dh_softmax_pv_tiled`` (the kernel's splits, per-tile online softmax and
  merge in split order, in plain PyTorch) against ``attention_from_logits``
  at the card tests' cases and against the reference's ``"dh"`` route, also
  at the smoke's four shapes cut to 1024 keys.

Tolerance: f32 throughout; the pair and the reference sum the same products
in other orders (a partial sum per slice, then the slices), so outputs agree
within ``rtol = 1e-5`` of the row's largest output magnitude; a bf16 output
one bf16 step more (``2^-7·|out|``), where the two f32 results round to
neighbours.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R

RTOL = 1e-5
D = 32  # d_head; M slices of D / M

# B, Hq, Hkv, Sq, cache rows, view start, q_offset, window, softcap
CASES = {
    "mha decode": (2, 4, 4, 1, 40, 0, 39, None, 0.0),
    "rep2 eight positions softcap": (2, 4, 2, 8, 40, 0, 32, None, 50.0),
    "rep6 decode": (1, 6, 1, 1, 40, 0, 39, None, 0.0),
    "rep6 eight positions": (2, 12, 2, 8, 40, 0, 30, None, 0.0),
    "window view at an offset softcap": (2, 4, 2, 1, 40, 21, 17, 8, 50.0),
    "rows with no live key": (1, 6, 1, 8, 24, 0, -3, None, 0.0),
}


def _inputs(case, seed):
    b, hq, hkv, sq, rows = case[:5]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, sq, D).astype(np.float32)
    cache_k = rng.randn(b, rows, hkv, D).astype(np.float32)  # [B, S, Hkv, D], as cached
    cache_v = rng.randn(b, rows, hkv, D).astype(np.float32)
    return q, cache_k, cache_v


def _view(cache, start):
    """The cache's rows a step reads, ``[start, rows)``, seen as ``[B, Hkv,
    S, D]`` in place."""
    return torch.from_numpy(cache)[:, start:].transpose(1, 2)


def _split_pair(q, k, v, m, **kw):
    """The pair on ``m`` slices of ``d_head``: partial logits summed over the
    slices, then each slice's output, concatenated."""
    dl = q.shape[-1] // m
    sl = [slice(i * dl, (i + 1) * dl) for i in range(m)]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = sum(FA.dh_logits(q[..., s], k[..., s], scale) for s in sl)
    return torch.cat([FA.dh_softmax_pv(logits, v[..., s], **kw) for s in sl], -1)


@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_pair_matches_the_reference_dh_route(name, m):
    case = CASES[name]
    b, hq, hkv, sq, rows, start, off, window, cap = case
    q, ck, cv = _inputs(case, seed=sorted(CASES).index(name))
    qt = torch.from_numpy(q)
    k, v = _view(ck, start), _view(cv, start)
    kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
    got = _split_pair(qt, k, v, m, **kw).numpy()
    want = np.asarray(jops.attention_chunked(
        jnp.asarray(q), jnp.asarray(k.contiguous().numpy()), jnp.asarray(v.contiguous().numpy()),
        block_q=8, block_k=16, shard_hint="dh", **kw))
    live = np.arange(sq) + off >= 0  # a row with a live key: its position sees key 0
    assert (~live).any() == (name == "rows with no live key")
    zeros = R.attention_ref(qt, k, v, **kw).numpy()[:, :, ~live]
    np.testing.assert_array_equal(zeros, 0.0)
    np.testing.assert_array_equal(got[:, :, ~live], zeros)
    scale = np.abs(want[:, :, live]).max(-1, keepdims=True)
    assert np.all(np.abs(got[:, :, live] - want[:, :, live]) <= RTOL * scale)


def test_custom_ops_fake_shapes_and_flops_are_the_plain_pairs():
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 6, 3, 8).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 2, 11, 8).astype(np.float32))
    kw = dict(causal=True, window=5, softcap=50.0, q_offset=9)
    blaze = torch.ops.blaze
    with FlopCounterMode(display=False) as plain:
        want = R.attention_from_logits(R.attention_logits(q, k, 0.25), k, q.dtype, **kw)
    with FlopCounterMode(display=False) as fc:
        logits = blaze.dh_logits(q, k, 0.25)
        got = blaze.dh_softmax_pv(logits, k, True, 5, 50.0, 9)
    assert torch.equal(got, want)
    assert fc.get_total_flops() == plain.get_total_flops() == 2 * (2 * 2 * 6 * 3 * 11 * 8)
    k16 = k.to(torch.bfloat16)
    with FakeTensorMode() as mode:
        fq, fk = mode.from_tensor(q), mode.from_tensor(k16)
        f_logits = blaze.dh_logits(fq, mode.from_tensor(k), 0.25)
        f_out = blaze.dh_softmax_pv(f_logits, fk, True, None, 0.0, None)
    assert f_logits.shape == logits.shape and f_logits.dtype == torch.float32
    assert f_out.shape == got.shape and f_out.dtype == torch.bfloat16


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, k = torch.zeros((1, 4, 1, 8)), torch.zeros((1, 2, 5, 8))
    logits = torch.zeros((1, 4, 1, 5))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        FA.dh_logits(q, torch.zeros((1, 3, 5, 8)), 1.0)
    with pytest.raises(ValueError, match="different slices"):
        FA.dh_logits(q, k[..., :4], 1.0)
    with pytest.raises(ValueError, match="d_head slice"):
        FA.dh_logits(torch.zeros((1, 4, 1, 130)), torch.zeros((1, 2, 5, 130)), 1.0)
    with pytest.raises(TypeError, match="f32 or bf16"):
        FA.dh_logits(q.half(), k.half(), 1.0)
    with pytest.raises(TypeError, match="both f32 or both bf16"):
        FA.dh_logits(q, k.bfloat16(), 1.0)
    with pytest.raises(TypeError, match="f32 logits"):
        FA.dh_softmax_pv(logits.bfloat16(), k)
    with pytest.raises(TypeError, match="f32 logits"):
        FA.dh_softmax_pv(logits[..., :4], k)
    with pytest.raises(TypeError, match="f32 or bf16"):
        FA.dh_softmax_pv(logits, k.half())
    with pytest.raises(ValueError, match="window"):
        FA.dh_softmax_pv(logits, k, window=-1)
    with pytest.raises(ValueError, match="\\[B, Hq"):
        FA.dh_softmax_pv(logits[0], k)


@pytest.mark.parametrize("impl", ["ref", "auto", "pallas"])
def test_sharded_dh_attention_on_cpu_runs_the_plain_pair(tmp_path, impl):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh

    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(2, 4, 1, 16).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(2, 2, 9, 16).astype(np.float32)) for _ in range(2))
    kw = dict(causal=True, window=4, softcap=50.0, q_offset=8)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        pl = SH.fitted_placements(mesh, q.shape, (SH.DP, None, None, SH.MODEL))
        dq, dk, dv = (DTensor.from_local(t, mesh, pl) for t in (q, k, v))
        plain, before = ops.attention.dh_plain_calls, (FA.dh_logits.launches,
                                                       FA.dh_softmax_pv.launches)
        got = ops.attention(dq, dk, dv, impl=impl, shard_hint="dh", **kw)
        assert ops.attention.dh_plain_calls == plain + 1
        assert (FA.dh_logits.launches, FA.dh_softmax_pv.launches) == before
        torch.testing.assert_close(got.full_tensor(), R.attention_ref(q, k, v, **kw),
                                   rtol=RTOL, atol=0.0)
        with pytest.raises(ValueError, match="unknown impl"):
            ops.attention(dq, dk, dv, impl="chunked", shard_hint="dh", **kw)
    finally:
        dist.destroy_process_group()


# (batch, head groups, live key tiles): dh_softmax_pv's splits at gemma2-9b's
# global and local layers, several head groups (Dl = 32 over 12 kv heads: 4
# a group), more batch rows than SMs, no live tile; then the plan's
# shapes: Hq, Hkv, Sq, Dl, bytes an element.
PLAN_CASES = [(8, 1, 512), (8, 1, 65), (1, 3, 7), (128, 1, 3), (8, 1, 0), (64, 1, 32),
              (2, 6, 200), (1, 1, 1)]
PLAN_SHAPES = {1: (16, 8, 1, 16, 2), 3: (24, 12, 1, 32, 2), 6: (48, 24, 2, 32, 4)}


@pytest.mark.parametrize("batch,groups,n_tiles", PLAN_CASES)
def test_splits_cover_every_live_tile_once(batch, groups, n_tiles):
    """``dh_plan``'s splits for ``dh_softmax_pv``: every live tile of every
    (batch row, head group) in exactly one CTA's run, no CTA empty, the
    fewest tiles a CTA that keep the grid within one wave of the card's
    resident CTAs, the ring's shared memory within budget."""
    hq, hkv, sq, dl, es = PLAN_SHAPES[groups]
    plan = FA.dh_plan("softmax_pv", batch, hq, hkv, sq, dl, es, True, 132, 3, 3 + n_tiles)
    assert plan.form == "ring" and plan.groups == groups
    assert plan.ctas == plan.splits * batch * groups
    if n_tiles > 0:
        runs = [range(plan.t_lo + s * plan.per, min(plan.t_hi, plan.t_lo + (s + 1) * plan.per))
                for s in range(plan.splits)]
        assert [t for run in runs for t in run] == list(range(3, 3 + n_tiles))
        assert all(len(run) > 0 for run in runs)  # no CTA empty
        target = max(1, min(-(-plan.ctas_per_sm * 132 // (batch * groups)),
                            FA.dh_merge_splits(plan.hg, hq // hkv * sq, dl, es, plan.stages)))
        assert plan.splits <= target
        assert plan.per == 1 or -(-n_tiles // (plan.per - 1)) > target
    else:
        assert (plan.splits, plan.per) == (1, 1)
    _assert_fits(plan, "softmax_pv", hq // hkv * sq, dl, es)


def _assert_fits(plan, kernel, rpk, dl, es):
    assert plan.smem == FA.dh_smem_bytes(kernel, plan.hg, rpk, dl, es, plan.stages)
    assert plan.smem <= FA.DH_SMEM_MAX
    assert 1 <= plan.ctas_per_sm == min(FA.dh_ctas_target(kernel, dl, rpk),
                                        FA.dh_ctas_fit(plan.smem))
    assert plan.ctas_per_sm * (plan.smem + FA.DH_CTA_RESERVE) <= FA.DH_SM_SMEM
    assert plan.hg * dl <= FA.DH_MAX_D
    if plan.form == "ring":
        assert 2 <= plan.stages <= FA.DH_STAGES and plan.hg * dl * es % 16 == 0
        # one stage more would cost a resident CTA or not fit at all
        deeper = plan.stages < FA.DH_STAGES and FA.dh_smem_bytes(
            kernel, plan.hg, rpk, dl, es, plan.stages + 1)
        assert not deeper or FA.dh_ctas_fit(deeper) < plan.ctas_per_sm
    else:
        assert plan.stages == 1


@pytest.mark.parametrize("batch,groups,n_tiles", PLAN_CASES)
def test_logits_plan_covers_every_item_once(batch, groups, n_tiles):
    """``dh_plan``'s runs for ``dh_logits``: every (batch row, head group,
    key tile) item in exactly one CTA's run, no CTA empty, no more CTAs than
    the card holds at once."""
    hq, hkv, sq, dl, es = PLAN_SHAPES[groups]
    n_tiles = max(1, n_tiles)  # dh_logits writes every key's logit
    plan = FA.dh_plan("logits", batch, hq, hkv, sq, dl, es, True, 132, 0, n_tiles)
    assert plan.form == "ring" and plan.groups == groups and plan.splits == 1
    items = batch * groups * n_tiles
    runs = [range(c * plan.per, min(items, (c + 1) * plan.per)) for c in range(plan.ctas)]
    assert [i for run in runs for i in run] == list(range(items))
    assert all(len(run) > 0 for run in runs)
    assert plan.ctas <= plan.ctas_per_sm * 132
    assert plan.per == 1 or -(-items // (plan.per - 1)) > plan.ctas_per_sm * 132
    _assert_fits(plan, "logits", hq // hkv * sq, dl, es)


@pytest.mark.parametrize("kernel", ["logits", "softmax_pv"])
@pytest.mark.parametrize("hkv,rpk,dl,es", [(8, 2, 16, 2), (8, 2, 16, 4), (24, 1, 4, 2),
                                           (4, 96, 8, 2), (2, 1, 128, 4), (3, 6, 3, 2),
                                           (1, 150, 8, 4)])
def test_plan_fits_the_shared_memory_budget(kernel, hkv, rpk, dl, es):
    """The head group is the widest that fits (in the ring form its runs
    16-byte aligned), the element form where no ring fits; a plan is cached
    per shape."""
    plan = FA.dh_plan(kernel, 2, hkv * rpk, hkv, 1, dl, es, True, 132, 0, 40)
    _assert_fits(plan, kernel, rpk, dl, es)
    wider = [hg for hg in range(plan.hg + 1, min(hkv, FA.DH_MAX_D // dl) + 1)
             if plan.form == "element" or hg * dl * es % 16 == 0]
    floor = 2 if plan.form == "ring" else 1
    assert all(FA.dh_smem_bytes(kernel, hg, rpk, dl, es, floor) > FA.DH_SMEM_MAX
               for hg in wider)
    assert FA.dh_plan(kernel, 2, hkv * rpk, hkv, 1, dl, es, True, 132, 0, 40) is plan


def test_sixteen_byte_loads_only_on_the_cache_layout():
    """The ring form's bulk copies take a key's heads as one 16-byte run:
    the cache's layout and its window views; not heads apart, a slice of a
    wider cache, or runs of 24 bytes."""
    cache = torch.zeros((8, 64, 8, 16), dtype=torch.bfloat16)  # a rank's [B, S, Hkv, Dl]
    assert FA._dh_ring(cache.transpose(1, 2))
    assert FA._dh_ring(cache[:, 5:40].transpose(1, 2))  # a window's view
    assert not FA._dh_ring(cache.transpose(1, 2).contiguous())  # [B, H, S, D]: heads apart
    whole = torch.zeros((8, 64, 8, 256), dtype=torch.bfloat16)
    assert not FA._dh_ring(whole[..., 16:32].transpose(1, 2))  # a slice of the whole cache
    small = torch.zeros((2, 10, 3, 4), dtype=torch.bfloat16)  # 3 heads of 8 bytes: 24 B a key
    assert not FA._dh_ring(small.transpose(1, 2))
    assert FA._dh_ring(torch.zeros((2, 10, 24, 4), dtype=torch.bfloat16).transpose(1, 2))
    # dh_softmax_pv's logits rows: any row stride (rows of 4097 floats, a
    # local layer's window), but contiguous along the keys from 16-byte
    # aligned data
    v = torch.zeros((2, 4097, 8, 16), dtype=torch.bfloat16).transpose(1, 2)
    logits = torch.zeros((2, 16, 1, 4098))
    plan = FA._dh_pv_plan
    assert plan(logits[..., :4097], v, 4096, True, 4096, 132).form == "ring"
    assert plan(logits[..., 1:], v, 4096, True, 4096, 132).form == "element"
    keys_apart = torch.zeros((2, 4097, 16, 1)).permute(0, 2, 3, 1)  # the keys 16 floats apart
    assert plan(keys_apart, v, 4096, True, None, 132).form == "element"


# The card tests' cases (tests/test_torch_cuda.py DH_CASES): b, hq, hkv, sq,
# cache rows, view start, d_head slice, layout, window, softcap, q_offset.
CARD_CASES = [
    (2, 16, 8, 1, 700, 0, 16, "cache", None, 50.0, 699),
    (2, 16, 8, 1, 700, 180, 16, "cache", 256, 50.0, 519),
    (2, 16, 8, 1, 700, 0, 8, "cache", None, 0.0, 699),
    (2, 24, 24, 1, 700, 0, 4, "cache", None, 0.0, 699),
    (1, 12, 2, 8, 300, 0, 8, "heads", 100, 0.0, 292),
    (1, 16, 8, 2, 333, 0, 32, "slice", None, 0.0, 331),
    (1, 6, 1, 8, 200, 0, 3, "cache", None, 0.0, -3),
    (3, 4, 2, 1, 65, 0, 1, "heads", None, 0.0, 64),
]
# The smoke's four "dh" shapes (chip_smoke.Smoke.dh_phase) at 1024 cached
# keys, not 32768: hq, hkv, d_head, view start, window, softcap (the local
# layer's window 256 over the last 257 rows, as 4096 over 4097 there).
SMOKE_SHAPES = {
    "gemma2-global": (16, 8, 256, 0, None, 50.0),
    "gemma2-local": (16, 8, 256, 1024 - 257, 256, 50.0),
    "qwen3": (16, 8, 128, 0, None, 0.0),
    "musicgen": (24, 24, 64, 0, None, 0.0),
}


def _card_inputs(case, dtype, seed):
    """A card case's summed logits (f32) and slice of v, the latter in its
    layout (a cache's transposed view, heads apart, or a slice of a wider
    cache), from numpy."""
    b, hq, hkv, sq, rows, start, dl, layout = case[:8]
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(b, hq, sq, rows - start).astype(np.float32) * 3)
    if layout == "heads":
        v = torch.from_numpy(rng.randn(b, hkv, rows, dl).astype(np.float32)).to(dtype)
        return logits, v[:, :, start:]
    wide = 4 * dl if layout == "slice" else dl
    v = torch.from_numpy(rng.randn(b, rows, hkv, wide).astype(np.float32)).to(dtype)
    v = v[:, start:, :, dl:2 * dl] if layout == "slice" else v[:, start:]
    return logits, v.transpose(1, 2)


def _hold(got, want, dtype):
    """Within ``RTOL`` of the row's largest magnitude, and one bf16 step
    (``2^-7·|want|``) more in bf16: the two round f32 values that differ in
    their last bits."""
    got, want = got.float(), want.float()
    tol = RTOL * want.abs().amax(-1, keepdim=True)
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.abs()
    assert bool(((got - want).abs() <= tol).all()), float(((got - want).abs() - tol).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_CASES)
def test_tiled_softmax_pv_is_attention_from_logits(case, dtype):
    """``dh_softmax_pv_tiled`` (the kernel's splits, tiles and merge) against
    the plain ``attention_from_logits`` at the card tests' cases; rows with
    no live key give zeros exactly."""
    window, cap, off = case[8:]
    logits, v = _card_inputs(case, dtype, CARD_CASES.index(case))
    kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
    plan = FA._dh_pv_plan(logits, v, off, True, window, 132)
    assert plan.form == ("ring" if case[7] == "cache" and case[2] * case[6] * v.element_size()
                         % 16 == 0 else "element")
    got = FA.dh_softmax_pv_tiled(logits, v, **kw)
    want = R.attention_from_logits(logits, v, dtype, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    _hold(got, want, dtype)
    if off < 0:
        assert not bool(got[:, :, :-off].float().abs().any())


@pytest.mark.parametrize("name", sorted(SMOKE_SHAPES))
def test_tiled_pair_at_the_smokes_shapes(name):
    """At the smoke's four shapes (1024 keys, batch 8, ``d_head`` in 16
    slices, f32): each slice's ``dh_softmax_pv_tiled`` against
    ``attention_from_logits`` on the summed logits, and the slices together
    against the reference's ``"dh"`` route; the plan splits the keys."""
    hq, hkv, d, start, window, cap = SMOKE_SHAPES[name]
    rng = np.random.RandomState(sorted(SMOKE_SHAPES).index(name))
    q = rng.randn(8, hq, 1, d).astype(np.float32) * 3
    ck, cv = (rng.randn(8, 1024, hkv, d).astype(np.float32) for _ in range(2))
    qt, k, v = torch.from_numpy(q), _view(ck, start), _view(cv, start)
    off = 1024 - start - 1
    kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
    dl = d // 16
    sl = [slice(i * dl, (i + 1) * dl) for i in range(16)]
    logits = sum(FA.dh_logits(qt[..., s], k[..., s], 1 / math.sqrt(d)) for s in sl)
    assert FA._dh_pv_plan(logits, v[..., sl[0]], off, True, window, 132).splits > 1
    outs = []
    for s in sl:
        got = FA.dh_softmax_pv_tiled(logits, v[..., s], **kw)
        _hold(got, R.attention_from_logits(logits, v[..., s], torch.float32, **kw),
              torch.float32)
        outs.append(got)
    want = np.asarray(jops.attention_chunked(
        jnp.asarray(q), jnp.asarray(k.contiguous().numpy()), jnp.asarray(v.contiguous().numpy()),
        block_q=8, block_k=64, shard_hint="dh", **kw))
    got = torch.cat(outs, -1).numpy()
    scale = np.abs(want).max(-1, keepdims=True)
    assert np.all(np.abs(got - want) <= RTOL * scale)


@pytest.mark.parametrize("m", [2, 16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tiled_split_pair_matches_the_reference_dh_route(name, m):
    """The pair of ``test_split_pair_matches_the_reference_dh_route`` with
    ``dh_softmax_pv_tiled`` in place of the plain softmax, on a card of 2
    SMs (so that even these short runs split)."""
    case = CASES[name]
    b, hq, hkv, sq, rows, start, off, window, cap = case
    q, ck, cv = _inputs(case, seed=sorted(CASES).index(name))
    qt = torch.from_numpy(q)
    k, v = _view(ck, start), _view(cv, start)
    kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
    dl = D // m
    sl = [slice(i * dl, (i + 1) * dl) for i in range(m)]
    logits = sum(FA.dh_logits(qt[..., s], k[..., s], 1.0 / math.sqrt(D)) for s in sl)
    got = torch.cat([FA.dh_softmax_pv_tiled(logits, v[..., s], sm_count=2, **kw) for s in sl],
                    -1).numpy()
    want = np.asarray(jops.attention_chunked(
        jnp.asarray(q), jnp.asarray(k.contiguous().numpy()), jnp.asarray(v.contiguous().numpy()),
        block_q=8, block_k=16, shard_hint="dh", **kw))
    live = np.arange(sq) + off >= 0
    np.testing.assert_array_equal(got[:, :, ~live], 0.0)
    scale = np.abs(want[:, :, live]).max(-1, keepdims=True)
    assert np.all(np.abs(got[:, :, live] - want[:, :, live]) <= RTOL * scale)
