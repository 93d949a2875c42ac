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
* The kernels' launch planning: splits covering every live key tile once,
  16-byte loads only on the cache's layout (the head groups, chosen by the
  kernels' source, are held on the card in ``tests/test_torch_cuda.py``).

Tolerance: f32 throughout; the pair and the reference sum the same products
in other orders (a partial sum per slice, then the slices), so outputs agree
within ``rtol = 1e-5`` of the row's largest output magnitude.
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


@pytest.mark.parametrize("batch,groups,n_tiles", [(8, 1, 512), (8, 1, 65), (1, 3, 7),
                                                   (128, 1, 3), (8, 1, 0)])
def test_splits_cover_every_live_tile_once(batch, groups, n_tiles):
    splits, per = FA.dh_splits(batch, groups, n_tiles, 132)
    assert splits >= 1 and per >= 1
    if n_tiles > 0:
        covered = [t for s in range(splits) for t in range(s * per, min(n_tiles, (s + 1) * per))]
        assert covered == list(range(n_tiles))  # every tile once, no split empty
        assert (splits - 1) * per < n_tiles
        # the fewest tiles a split that keep to the target of CTAs an SM
        target = max(1, -(-FA.DH_CTAS_PER_SM * 132 // (batch * groups)))
        assert splits <= target and (per == 1 or -(-n_tiles // (per - 1)) > target)


def test_sixteen_byte_loads_only_on_the_cache_layout():
    cache = torch.zeros((8, 64, 8, 16), dtype=torch.bfloat16)  # a rank's [B, S, Hkv, Dl]
    assert FA._dh_vec(cache.transpose(1, 2), 8)
    assert FA._dh_vec(cache[:, 5:40].transpose(1, 2), 8)  # a window's view
    assert not FA._dh_vec(cache.transpose(1, 2).contiguous(), 8)  # [B, H, S, D]: heads apart
    whole = torch.zeros((8, 64, 8, 256), dtype=torch.bfloat16)
    assert not FA._dh_vec(whole[..., 16:32].transpose(1, 2), 8)  # a slice of the whole cache
    small = torch.zeros((2, 10, 3, 4), dtype=torch.bfloat16)  # 3 heads of 8 bytes: 24 B a key
    assert not FA._dh_vec(small.transpose(1, 2), 3)
    assert FA._dh_vec(torch.zeros((2, 10, 24, 4), dtype=torch.bfloat16).transpose(1, 2), 24)
