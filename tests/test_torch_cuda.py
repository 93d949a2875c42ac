"""Tests of the port that need a CUDA card; each skips without one.

This file imports only ``torch`` and ``repro_torch`` (no JAX), so it runs on a
machine that has the card but not the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The kernels are held against their plain PyTorch versions on the same device
tensors; integer results and min/max are exact.  K3's assignments are exact
except at near ties (``near_ties``), and its sums within ``1e-5`` relative
plus ``1e-5`` of the sum of the addends' magnitudes (f32 sums, in the stream
form's fixed order or by atomics in an order the kernel does not fix,
against float64); on a view that starts inside a buffer its assignments
equal the same kernel's on a contiguous copy exactly, and the stream form's
repeated calls equal the first bit for bit.  K4 (flash attention) within
``3e-5`` of ``attention_ref`` in f32, and in bf16 within one bf16 step of the
output (``2^-7·|out|``) plus that, plus ``2^-8·attention_ref(q, k, |v|)`` for
the probabilities the tensor-core forms round to bf16; a full-width qwen3-0.6b decode step's
logits within ``chip_smoke.LM_LOGIT_TOL`` of the plain path's; the reduced
MoE, M-RoPE and embedding-fed models' logits in f32 within ``1e-3`` of the
plain path's (K4 within ``3e-5`` an output, far below the routers' gaps).  K5 and K6
(the SSD and wkv scans) against their plain chunked versions: both compute
in f32 over chunks of other lengths, so states and f32 outputs of O(1)
inputs agree within ``atol = rtol = 1e-4``, bf16 outputs within one bf16
step more (``2^-7``); the in-place and strided-view calls equal the plain
calls of the same kernel exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import BlazeSession
from repro_torch.core.algorithms import gmm_em, pagerank
from repro_torch.data.synthetic import cluster_points, rmat_edges
from repro_torch.configs.base import MAMBA2, RWKV6, get_arch
from repro_torch.kernels import hash_combine as HK
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention, form
from repro_torch.kernels.kmeans_assign import (
    kmeans_assign,
    kmeans_assign_plain,
    launch_shape,
    near_ties,
)
from repro_torch.kernels.ref import attention_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain
from repro_torch.kernels import segment_reduce as SR
from repro_torch.kernels import ssd_scan as SS
from repro_torch.kernels._build import sm_count
from repro_torch.kernels.segment_reduce import segment_reduce, segment_reduce_plain
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models import model as M


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def test_kernels_match_plain_versions_on_the_card(dev):
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(-2, 70, (5000,), generator=g, dtype=torch.int32).to(dev)
    vals = torch.randint(-8, 9, (5000, 3), generator=g).to(dev)
    for dtype in (torch.float32, torch.int32):
        for reducer in ("sum", "min", "max"):
            got = segment_reduce(ids, vals.to(dtype), 64, reducer=reducer)
            want = segment_reduce_plain(ids, vals.to(dtype), 64, reducer=reducer)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    keys = torch.where(ids < 0, HK.EMPTY_KEY, ids * 7919).to(torch.int32)
    got = HK.hash_aggregate(keys, vals.to(torch.int32), 256)
    want = HK.hash_aggregate_plain(keys, vals.to(torch.int32), 256)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ids = torch.zeros(8, dtype=torch.int32, device=dev)
    vals = torch.ones((8, 2), device=dev)
    with pytest.raises(ValueError, match="CUDA device"):
        segment_reduce(ids.cpu(), vals, 4)
    with pytest.raises(TypeError, match="int32"):
        segment_reduce(ids.long(), vals, 4)
    with pytest.raises(TypeError, match="f32/bf16/i32"):
        HK.hash_aggregate(ids, vals.double(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        segment_reduce(ids, torch.ones((2, 8), device=dev).t(), 4)


def test_empty_stream_launches_nothing(dev):
    before = segment_reduce.launches
    out = segment_reduce(torch.zeros(0, dtype=torch.int32, device=dev),
                         torch.zeros((0, 2), device=dev), 3, reducer="min")
    assert segment_reduce.launches == before
    assert torch.equal(out, torch.full((3, 2), float("inf"), device=dev))


# n, v, k: the register form at its key limit (REG_K = 8) and one past it
# (shared), V that divides 4 and V that does not (GMM's 9), N off every grid,
# a key range too wide for shared memory (global), rows wide enough that the
# global form's table of hot keys shrinks (V = 1000: 4 slots) or is left out
# (V = 5000; V = 12,289, one row past 48 KiB).
SEGMENT_CASES = [
    (5003, 4, 8, "registers"), (5003, 4, 9, "shared"), (4097, 9, 5, "registers"),
    (777, 1, 3, "registers"), (70_001, 2, 8, "registers"), (3001, 3, 64, "shared"),
    (3001, 2, 20_000, "global"), (401, 1000, 20, "global"), (203, 5000, 3, "global"),
    (301, 12_289, 1, "global"),
]


@pytest.mark.parametrize("n,v,k,want_form", SEGMENT_CASES)
def test_segment_reduce_forms_match_plain_version(dev, n, v, k, want_form):
    """Every reducer on i32 exactly; f32 min/max exactly with NaN on live and
    dropped lanes; f32 sums within 1e-5 of the float64 sum's magnitude; ids
    out of range dropped."""
    form, _ = SR.launch_shape(n, v, k, sm_count(dev.index or 0))
    assert form == want_form
    g = torch.Generator().manual_seed(n + k)
    ids = torch.randint(-3, k + 3, (n,), generator=g, dtype=torch.int32).to(dev)
    ints = torch.randint(-50, 51, (n, v), generator=g, dtype=torch.int32).to(dev)
    before = dict(SR.segment_reduce.forms)
    for reducer in ("sum", "prod", "min", "max"):
        got = segment_reduce(ids, ints, k, reducer=reducer)
        want = segment_reduce_plain(ids, ints, k, reducer=reducer)
        assert torch.equal(got, want), reducer
    assert SR.segment_reduce.forms[form] == before[form] + 4
    x = torch.randn((n, v), generator=g).to(dev)
    x[::7, 0] = float("nan")
    for reducer in ("min", "max"):
        got = segment_reduce(ids, x, k, reducer=reducer)
        want = segment_reduce_plain(ids, x, k, reducer=reducer)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    x = x.nan_to_num(0.0)
    got = segment_reduce(ids, x, k)
    want = segment_reduce_plain(ids, x, k)
    mag = segment_reduce_plain(ids, x.abs(), k)
    assert bool(((got - want).abs() <= 1e-5 * mag + 1e-6).all())
    bf = segment_reduce(ids, x.bfloat16(), k)
    torch.testing.assert_close(bf, segment_reduce_plain(ids, x.bfloat16(), k),
                               rtol=0, atol=1e-5 * float(mag.max()) + 1e-6)


def test_session_defaults_to_the_card_and_launches_the_kernel(dev):
    sess = BlazeSession()
    assert sess.device.type == "cuda"
    edges = rmat_edges(8, 8, seed=1)
    segment_reduce.launches = 0
    got = pagerank(edges, 256, tol=0.0, max_iters=5, engine="pallas", session=sess)
    assert segment_reduce.launches == 5 and got.compiles == 3
    want = pagerank(edges, 256, tol=0.0, max_iters=5, engine="eager",
                    session=BlazeSession(device="cpu"))
    assert float(np.abs(got.scores - want.scores).max()) <= 1e-6


def _check_kmeans(pts, ctr):
    got_a, got_s = kmeans_assign(pts, ctr)
    want_a, _ = kmeans_assign_plain(pts, ctr)
    torch.cuda.synchronize()
    decided = ~near_ties(pts, ctr)
    assert torch.equal(got_a[decided], want_a[decided])
    # Sums under the kernel's own assignment, in float64.
    x1 = torch.cat([pts, torch.ones_like(pts[:, :1])], 1).double()
    k = ctr.shape[0]
    want = torch.zeros((k, x1.shape[1]), dtype=torch.float64, device=pts.device)
    want.index_add_(0, got_a.long(), x1)
    mag = torch.zeros_like(want).index_add_(0, got_a.long(), x1.abs())
    assert bool(((got_s.double() - want).abs() <= 1e-5 * want.abs() + 1e-5 * mag).all())
    return got_a, got_s


@pytest.mark.parametrize("n,d,k,form", [
    (1000, 3, 5, "stream"), (70_001, 3, 5, "stream"),
    (3001, 4, 8, "stream"), (777, 8, 13, "shared"), (50_003, 5, 2, "shared"),
    (5000, 16, 600, "global"),
    (5000, 1, 8, "stream"), (4100, 4, 1, "stream"), (2500, 1, 1, "stream"),
    (100, 4, 8, "stream"), (3, 3, 5, "stream"), (5003, 3, 5, "stream"),
])
def test_kmeans_kernel_matches_plain_version(dev, n, d, k, form):
    """N off the tile, every form: [600, 16] needs 600·34·4 B of shared
    memory, over the 48 KiB budget, so it runs the global form.  The stream
    form at D = 1 and 4, K = 1 and 8, under one tile (every point read with
    plain loads) and N not a multiple of 4."""
    g = torch.Generator().manual_seed(n)
    pts = torch.randn((n, d), generator=g).to(dev)
    ctr = torch.randn((k, d), generator=g).to(dev)
    assert launch_shape(n, d, k, dev)[0] == form
    before = kmeans_assign.launches
    _check_kmeans(pts, ctr)
    assert kmeans_assign.launches == before + 1


@pytest.mark.parametrize("d,unit,start", [
    *[(d, "points", start) for d in (1, 2, 3, 4) for start in (1, 2, 3)],
    *[(d, "floats", start) for d in (2, 4) for start in (1, 2, 3)],
])
def test_kmeans_kernel_reads_views_that_start_inside_a_buffer(dev, d, unit, start):
    """A contiguous view 1–3 points into a buffer (the stream form peels a
    head of up to 3 points), or 1–3 floats in (at D = 2 and 4 no point then
    starts on 16 bytes, and each tile is copied from the 16 bytes below it):
    one launch, sums as the plain version's, assignments those of the same
    kernel on a contiguous copy."""
    n, k = 70_001, 5
    g = torch.Generator().manual_seed(d + 10 * start)
    buf = torch.randn(((n + 3) * d,), generator=g).to(dev)
    first = start * d if unit == "points" else start
    pts = buf[first:first + n * d].view(n, d)
    ctr = torch.randn((k, d), generator=g).to(dev)
    assert buf.data_ptr() % 16 == 0 and pts.data_ptr() - buf.data_ptr() == 4 * first
    before = kmeans_assign.launches
    a, _ = _check_kmeans(pts, ctr)
    assert kmeans_assign.launches == before + 1
    assert torch.equal(a, kmeans_assign(pts.clone(), ctr)[0])


@pytest.mark.parametrize("start", [0, 1])
def test_kmeans_kernel_repeated_calls_are_bit_equal(dev, start):
    """The stream form merges its sums in a fixed order and adds into no
    memory it did not write in the same call: 100 calls give the first
    call's bits."""
    g = torch.Generator().manual_seed(start)
    pts = torch.randn((1_000_003 + start, 3), generator=g).to(dev)[start:]
    ctr = torch.randn((5, 3), generator=g).to(dev)
    a0, s0 = _check_kmeans(pts, ctr)
    for _ in range(100):
        a, s = kmeans_assign(pts, ctr)
        assert torch.equal(a, a0) and torch.equal(s, s0)


def test_kmeans_stream_instance_for_fig6_does_not_spill(dev):
    """The compiler's report (``-Xptxas -v``, beside the built library) for
    the stream form's D = 3, K = 5 instance: no spill stores or loads."""
    import re

    from repro_torch.kernels import _build

    _build.load("kmeans_assign")
    log = _build.library_path("kmeans_assign").with_suffix(".so.log").read_text()
    entries = [e for e in log.split("Compiling entry function")
               if "kmeans_assign_streamILi3ELi5E" in e]
    assert len(entries) == 1, log
    assert "0 bytes spill stores, 0 bytes spill loads" in entries[0], entries[0]
    assert re.search(r"Used \d+ registers", entries[0]), entries[0]


def test_kmeans_kernel_ties_pick_the_first_index(dev):
    ctr = torch.tensor([[0.0, 2.0], [0.5, -1.0], [0.5, -1.0]], device=dev)
    pts = torch.tensor([0.5, -1.0], device=dev) + 0.1 * torch.randn(
        (4099, 2), generator=torch.Generator().manual_seed(0)).to(dev)
    a, s = _check_kmeans(pts, ctr)
    assert bool((a == 1).all()) and float(s[1, -1]) == 4099.0


def test_kmeans_kernel_empty_input_launches_nothing(dev):
    before = kmeans_assign.launches
    a, s = kmeans_assign(torch.zeros((0, 3), device=dev), torch.ones((5, 3), device=dev))
    assert kmeans_assign.launches == before
    assert a.shape == (0,) and torch.equal(s, torch.zeros((5, 4), device=dev))
    with pytest.raises(TypeError, match="f32"):
        kmeans_assign(torch.zeros((4, 3), device=dev).double(), torch.ones((5, 3), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        kmeans_assign(torch.zeros((3, 4), device=dev).t(), torch.ones((5, 3), device=dev))


def test_ops_auto_launches_the_kernels_on_the_card(dev):
    pts = torch.randn((4096, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    before = kmeans_assign.launches
    ops.kmeans_assign(pts, pts[:5].contiguous(), impl="auto")
    assert kmeans_assign.launches == before + 1
    ids = torch.zeros(4096, dtype=torch.int32, device=dev)
    before = segment_reduce.launches
    ops.segment_reduce(ids, pts, 2, impl="auto")
    assert segment_reduce.launches == before + 1


def test_gmm_on_the_card_launches_three_segment_reduces_per_round(dev):
    pts, _ = cluster_points(3000, 2, 3, seed=1)
    segment_reduce.launches = 0
    got = gmm_em(pts, 3, init_mu=pts[:3].copy(), tol=0.0, max_iters=4,
                 engine="pallas", session=BlazeSession())
    assert segment_reduce.launches == 3 * 4 and got.compiles == 4
    want = gmm_em(pts, 3, init_mu=pts[:3].copy(), tol=0.0, max_iters=4,
                  engine="eager", session=BlazeSession(device="cpu"))
    assert abs(got.log_likelihood - want.log_likelihood) <= 1e-5 * abs(want.log_likelihood)
    np.testing.assert_allclose(got.mu, want.mu, atol=1e-4, rtol=0)


# B, Hq, Hkv, Sq, Skv, D, causal, window, softcap, q_offset: the JAX kernel
# tests' cases (q_offset None = Skv - Sq), then offsets, the configs' head
# dims (80, 112, 256) and ragged edges.
ATTN_CASES = [
    (2, 4, 2, 64, 64, 32, True, None, 0.0, None),
    (1, 8, 8, 128, 128, 64, True, None, 0.0, None),
    (2, 4, 4, 96, 96, 32, True, 32, 0.0, None),
    (1, 4, 2, 64, 64, 32, False, None, 0.0, None),
    (1, 4, 2, 64, 64, 32, True, None, 20.0, None),
    (2, 8, 2, 1, 256, 64, True, None, 0.0, None),
    (1, 4, 4, 7, 133, 32, True, None, 0.0, None),
    (1, 2, 1, 33, 65, 16, True, 16, 5.0, None),
    (2, 4, 2, 40, 100, 128, True, None, 0.0, 0),
    (2, 4, 2, 1, 100, 128, True, None, 0.0, 77),
    (1, 4, 2, 3, 300, 80, True, 64, 0.0, 250),
    (1, 2, 1, 70, 70, 112, True, None, 0.0, None),
    (1, 4, 2, 130, 200, 256, True, 100, 50.0, 60),
    (1, 2, 2, 5, 16, 8, True, None, 0.0, -2),
    # bf16 decode form: many splits at rep 8, rep 8 with D = 112 and two
    # positions (16 rows), D = 256 with a window and softcap, and a window
    # that leaves the later rows nothing in the first split.
    (2, 16, 2, 1, 2000, 128, True, None, 0.0, 1999),
    (2, 8, 1, 2, 700, 112, True, None, 0.0, 690),
    (1, 4, 2, 1, 1500, 256, True, 300, 50.0, 1400),
    (1, 2, 2, 16, 700, 64, True, 40, 0.0, 600),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_matches_plain_version(dev, case, dtype):
    b, hq, hkv, sq, skv, d, causal, window, cap, off = case
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g).mul(0.5).to(dev, dtype)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    before, forms = flash_attention.launches, dict(flash_attention.forms)
    got = ops.attention(q, k, v, impl="auto", **kw)
    assert flash_attention.launches == before + 1
    forms[form(q, k)] += 1
    assert flash_attention.forms == forms  # one call, counted under its form
    want = attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=3e-5, rtol=0.0)
        return
    # bf16: one bf16 step of the output, and the probabilities' rounding to
    # bf16 for p·v, 2^-8·Σ p|v| / l.
    tol = (3e-5 + 2.0 ** -7 * want.float().abs()
           + 2.0 ** -8 * attention_ref(q.float(), k.float(), v.float().abs(), **kw))
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


def test_flash_attention_reads_a_cache_view_in_place(dev):
    g = torch.Generator().manual_seed(1)
    ck, cv = (torch.randn((2, 50, 2, 64), generator=g).to(dev, torch.bfloat16)
              for _ in range(2))
    q = torch.randn((2, 1, 4, 64), generator=g).to(dev, torch.bfloat16).transpose(1, 2)
    k, v = ck[:, 8:40].transpose(1, 2), cv[:, 8:40].transpose(1, 2)
    got = flash_attention(q, k, v, window=16, q_offset=30)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=16,
                           q_offset=30)
    assert torch.equal(got, want)
    assert got.transpose(1, 2).is_contiguous()  # the output keeps q's layout


def test_flash_attention_refuses_what_the_kernel_does_not_take(dev):
    q = torch.zeros((1, 2, 4, 16), device=dev)
    with pytest.raises(TypeError, match="f32 or all bf16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention(q[..., :12], q[..., :12], q[..., :12])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, torch.zeros((1, 2, 16, 4), device=dev).transpose(2, 3), q)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, q.cpu(), q)


# K4's "dh" form: b, hq, hkv, sq, cache rows, view start, d_head slice,
# layout, window, softcap, q_offset.  Layouts: "cache", a rank's [B, S, Hkv,
# Dl] buffer seen as [B, Hkv, S, Dl] (16-byte loads); "heads", a contiguous
# [B, Hkv, S, Dl]; "slice", Dl of a wider [B, S, Hkv, 4·Dl] cache (both read
# an element a load).  gemma2-9b's, qwen3-0.6b's and musicgen-medium's
# decode_32k slices, eight positions at rep 6, several head groups (Dl =
# 32 at 8 kv heads), ragged key tiles, a window's view, rows with no key.
DH_CASES = [
    (2, 16, 8, 1, 700, 0, 16, "cache", None, 50.0, 699),
    (2, 16, 8, 1, 700, 180, 16, "cache", 256, 50.0, 519),
    (2, 16, 8, 1, 700, 0, 8, "cache", None, 0.0, 699),
    (2, 24, 24, 1, 700, 0, 4, "cache", None, 0.0, 699),
    (1, 12, 2, 8, 300, 0, 8, "heads", 100, 0.0, 292),
    (1, 16, 8, 2, 333, 0, 32, "slice", None, 0.0, 331),
    (1, 6, 1, 8, 200, 0, 3, "cache", None, 0.0, -3),
    (3, 4, 2, 1, 65, 0, 1, "heads", None, 0.0, 64),
]


def _dh_tensor(g, case, dev, dtype):
    b, hq, hkv, sq, rows, start, dl, layout = case[:8]
    wide = 4 * dl if layout == "slice" else dl
    if layout == "heads":
        x = torch.randn((b, hkv, rows, dl), generator=g).to(dev, dtype)
        return x[:, :, start:]
    x = torch.randn((b, rows, hkv, wide), generator=g).to(dev, dtype)
    return x[:, start:, :, dl:2 * dl].transpose(1, 2) if layout == "slice" else \
        x[:, start:].transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DH_CASES)
def test_dh_kernels_match_plain_versions(dev, case, dtype):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import attention_from_logits, attention_logits

    b, hq, hkv, sq, rows, start, dl, layout, window, cap, off = case
    g = torch.Generator().manual_seed(0)
    q = (torch.randn((b, sq, hq, dl), generator=g) * 0.5).to(dev, dtype).transpose(1, 2)
    k, v = _dh_tensor(g, case, dev, dtype), _dh_tensor(g, case, dev, dtype)
    before = (FA.dh_logits.launches, FA.dh_softmax_pv.launches)
    logits = FA.dh_logits(q, k, 0.3)
    want = attention_logits(q, k, 0.3)
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
    kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
    got = FA.dh_softmax_pv(want, v, **kw)
    assert (FA.dh_logits.launches, FA.dh_softmax_pv.launches) == (before[0] + 1,
                                                                  before[1] + 1)
    ref = attention_from_logits(want, v, dtype, **kw)
    assert got.dtype == dtype and got.shape == ref.shape == (b, hq, sq, dl)
    tol = 3e-5 + (2.0 ** -7 * ref.float().abs() if dtype == torch.bfloat16 else 0.0)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= tol).all()), float((err - tol).max())
    if off < 0:  # rows before the first key see nothing: zeros
        assert not bool(got[:, :, :-off].float().abs().any())


def test_dh_split_pair_is_attention_on_the_card(dev):
    from repro_torch.kernels import flash_attention as FA

    g = torch.Generator().manual_seed(2)
    q = (torch.randn((2, 16, 1, 64), generator=g) * 0.5).to(dev, torch.bfloat16)
    cache = torch.randn((2, 600, 8, 64), generator=g).to(dev, torch.bfloat16)
    k = v = cache.transpose(1, 2)
    kw = dict(causal=True, window=300, softcap=50.0, q_offset=599)
    parts = [(q[..., i:i + 16], cache[..., i:i + 16].contiguous().transpose(1, 2))
             for i in range(0, 64, 16)]  # four ranks' slices
    logits = sum(FA.dh_logits(qs, ks, 1 / 8) for qs, ks in parts)
    got = torch.cat([FA.dh_softmax_pv(logits, ks, **kw) for _, ks in parts], -1)
    want = attention_ref(q, k, v, **kw)
    tol = (3e-5 + 2.0 ** -7 * want.float().abs()
           + 2.0 ** -8 * attention_ref(q.float(), k.float(), v.float().abs(), **kw))
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def test_dh_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels import flash_attention as FA

    q, k = torch.zeros((1, 4, 1, 8), device=dev), torch.zeros((1, 2, 5, 8), device=dev)
    with pytest.raises(ValueError, match="CUDA device"):
        FA.dh_logits(q, k.cpu(), 1.0)
    with pytest.raises(ValueError, match="shared memory"):
        FA.dh_softmax_pv(torch.zeros((1, 2000, 8, 5), device=dev),
                         torch.zeros((1, 1, 5, 32), device=dev))


@pytest.mark.parametrize("hkv,rows,dl,kernel,want", [
    (8, 2, 16, "logits", 8),        # gemma2-9b decode_32k: 16 / 8 heads, 256 -> 16
    (8, 2, 16, "softmax_pv", 8),
    (24, 1, 4, "softmax_pv", 24),   # musicgen-medium: 24 MHA heads, 64 -> 4
    (8, 6, 8, "softmax_pv", 8),     # mixtral-8x22b: 48 / 8 heads, 128 -> 8
    (4, 96, 8, "softmax_pv", 1),    # starcoder2-like rep 12 at 8 positions: shared memory
    (2, 1, 128, "logits", 1),       # a whole 128-wide slice a head
])
def test_dh_head_groups_fit_the_shared_memory_budget(dev, hkv, rows, dl, kernel, want):
    """The plan's head group (bf16, the ring form) at these shapes, and its
    shared memory as the kernels' source counts it (``blaze_dh_smem_bytes``)
    for every depth; a kv head of 1000 rows fits neither form."""
    from repro_torch.kernels import flash_attention as FA

    plan = FA.dh_plan(kernel, 1, hkv * rows, hkv, 1, dl, 2, True, sm_count(0), 0, 8)
    assert (plan.hg, plan.form) == (want, "ring")
    smem = FA._dh_kernel("blaze_dh_smem_bytes")
    for es in (2, 4):
        for stages in range(1, FA.DH_STAGES + 1):
            assert smem(int(kernel == "softmax_pv"), plan.hg, rows, dl, es, stages) == \
                FA.dh_smem_bytes(kernel, plan.hg, rows, dl, es, stages)
    with pytest.raises(ValueError, match="shared memory"):
        FA.dh_plan(kernel, 1, 1000, 1, 1, 32, 2, True, sm_count(0), 0, 8)


@pytest.mark.parametrize("case", DH_CASES)
def test_dh_kernels_take_the_ring_form_on_the_cache_layout(dev, case):
    """Bulk copies take the cache's layout where a key's heads are a 16-byte
    run (every "cache" case but the 3-wide slice); the "heads" and "slice"
    layouts take the element form.  Each call one launch, of its form."""
    from repro_torch.kernels import flash_attention as FA

    b, hq, hkv, sq, rows, start, dl, layout, window, cap, off = case
    g = torch.Generator().manual_seed(1)
    q = torch.randn((b, sq, hq, dl), generator=g).to(dev, torch.bfloat16).transpose(1, 2)
    k = _dh_tensor(g, case, dev, torch.bfloat16)
    want = "ring" if layout == "cache" and hkv * dl * 2 % 16 == 0 else "element"
    for fn, args, kw in ((FA.dh_logits, (q, k, 0.3), {}),
                         (FA.dh_softmax_pv, (torch.randn((b, hq, sq, k.shape[2]),
                                                         device=dev), k),
                          dict(causal=True, window=window, softcap=cap, q_offset=off))):
        before, forms = fn.launches, dict(fn.forms)
        fn(*args, **kw)
        assert fn.launches == before + 1
        assert {f: fn.forms[f] - forms[f] for f in forms} == {
            f: int(f == want) for f in FA.DH_FORMS}


def _dh_cache_pair(dev, b, seed=5):
    """q, k, v and the f32 logits of a gemma2-9b decode_32k rank's slice
    (16 query heads over 8 kv heads of 16, bf16) over 2048 cached keys."""
    from repro_torch.kernels import flash_attention as FA

    g = torch.Generator().manual_seed(seed)
    q = (torch.randn((b, 1, 16, 16), generator=g) * 3).to(dev, torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((b, 2048, 8, 16), generator=g).to(dev, torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    return q, k, v, FA.dh_logits(q, k, 0.25)


def test_dh_kernels_repeat_their_bits(dev):
    """Two calls of each kernel give the same bits: the split merge runs in
    split order whichever CTA of a group ends last (32 splits here)."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v, logits = _dh_cache_pair(dev, 2)
    kw = dict(causal=True, window=None, softcap=50.0, q_offset=2047)
    assert FA._dh_pv_plan(logits, v, 2047, True, None, sm_count(0)).splits > 1
    assert torch.equal(FA.dh_logits(q, k, 0.25), logits)
    first = FA.dh_softmax_pv(logits, v, **kw)
    for _ in range(3):
        assert torch.equal(FA.dh_softmax_pv(logits, v, **kw), first)


def test_dh_pair_replays_in_a_cuda_graph_bit_for_bit(dev):
    """``dh_logits`` and ``dh_softmax_pv`` captured in one CUDA graph and
    replayed twice equal the eager calls bit for bit; the outputs are wiped
    before the second replay, so it shows the split counters reset
    themselves (a counter left over would leave no CTA last, and nothing
    written)."""
    from repro_torch.kernels import flash_attention as FA

    q, k, v, logits = _dh_cache_pair(dev, 2, seed=6)
    kw = dict(causal=True, window=1024, softcap=50.0, q_offset=2047)
    want = FA.dh_softmax_pv(logits, v, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up on the capturing stream
        FA.dh_softmax_pv(FA.dh_logits(q, k, 0.25), v, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got_logits = FA.dh_logits(q, k, 0.25)
        got = FA.dh_softmax_pv(got_logits, v, **kw)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got_logits, logits) and torch.equal(got, want)
        got_logits.fill_(float("nan"))
        got.fill_(float("nan"))


def test_dh_softmax_pv_merges_many_groups_at_once(dev):
    """Batch 64: 64 (batch row, head group) pairs × 5 splits, more CTAs than
    one wave, so many groups' last CTAs merge at once; held to the plain
    version within ``test_dh_kernels_match_plain_versions``' tolerance."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.ref import attention_from_logits

    q, k, v, logits = _dh_cache_pair(dev, 64, seed=7)
    kw = dict(causal=True, window=None, softcap=50.0, q_offset=2047)
    plan = FA._dh_pv_plan(logits, v, 2047, True, None, sm_count(0))
    assert plan.ctas > plan.ctas_per_sm * sm_count(0) and plan.splits > 1
    got = FA.dh_softmax_pv(logits, v, **kw)
    ref = attention_from_logits(logits, v, torch.bfloat16, **kw)
    tol = 3e-5 + 2.0 ** -7 * ref.float().abs()
    err = (got.float() - ref.float()).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["auto", "pallas", "ref"])
def test_sharded_dh_attention_on_the_card_launches_the_kernels(dev, tmp_path, impl, dtype):
    """``ops.attention(shard_hint="dh")`` on CUDA ``DTensor``s (an NCCL
    group of one, a (1, 1) mesh) whose locals are a cache's window view at
    an offset, as the model reads it: "auto" and "pallas" launch
    ``dh_logits`` and ``dh_softmax_pv`` once each and run no plain pair,
    "ref" the plain pair alone; the output within the tolerance of
    ``test_dh_kernels_match_plain_versions`` of ``attention_ref``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.mesh import make_mesh

    g = torch.Generator().manual_seed(4)
    q = (torch.randn((2, 1, 4, 32), generator=g) * 0.5).to(dev, dtype).transpose(1, 2)
    k, v = (torch.randn((2, 40, 2, 32), generator=g).to(dev, dtype)[:, 21:].transpose(1, 2)
            for _ in range(2))
    kw = dict(causal=True, window=8, softcap=50.0, q_offset=17)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "s"), 1),
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        pl = SH.fitted_placements(mesh, q.shape, (SH.DP, None, None, SH.MODEL))
        dq, dk, dv = (DTensor.from_local(t, mesh, pl) for t in (q, k, v))
        plain, before = ops.attention.dh_plain_calls, (FA.dh_logits.launches,
                                                       FA.dh_softmax_pv.launches)
        got = ops.attention(dq, dk, dv, impl=impl, shard_hint="dh", **kw).full_tensor()
        kernels = impl != "ref"
        assert ops.attention.dh_plain_calls == plain + (not kernels)
        assert (FA.dh_logits.launches, FA.dh_softmax_pv.launches) == (
            before[0] + kernels, before[1] + kernels)
    finally:
        dist.destroy_process_group()
    want = attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == want.shape == (2, 4, 1, 32)
    tol = 3e-5 + (2.0 ** -7 * want.float().abs() if dtype == torch.bfloat16 else 0.0)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


def _full_width(arch, layers=None):
    """``arch`` at full width, cut to its first ``layers`` layers (whole
    stages: gemma2-9b's is a local and a global layer), else whole."""
    import dataclasses

    cfg = get_arch(arch)
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers,
                               n_stages=layers // len(cfg.stage_pattern))


@pytest.mark.parametrize("arch, layers", [("qwen3-0.6b", None), ("gemma2-9b", 2),
                                          ("stablelm-3b", 2), ("starcoder2-15b", 2)])
def test_qwen3_full_width_decode_step_matches_the_plain_path(dev, arch, layers):
    """A decode step at full width (qwen3-0.6b at full depth; gemma2-9b's
    heads of 256 with its softcaps, stablelm-3b's MHA of 80 and
    starcoder2-15b's 12 query rows a kv head at 2 layers) against the plain
    path, within the smoke's ``LM_LOGIT_TOL``, K4 launched once a layer."""
    import chip_smoke

    cfg = _full_width(arch, layers)
    g = torch.Generator(device=dev).manual_seed(0)
    params = M.init(g, cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 64), generator=g, device=dev)
    out = {}
    for impl in ("auto", "ref"):
        caches = M.make_caches(cfg, 2, 80, dev)
        _, caches = M.prefill(params, cfg, prompts, caches, attn_impl=impl)
        flash_attention.launches = 0
        out[impl], _ = M.decode_step(params, cfg, prompts[:, -1:], caches, 64,
                                     attn_impl=impl)
        assert flash_attention.launches == (cfg.n_layers if impl == "auto" else 0)
    assert out["auto"].dtype == torch.float32 and out["auto"].shape == (2, cfg.vocab)
    err = float((out["auto"] - out["ref"]).abs().max())
    assert err <= chip_smoke.LM_LOGIT_TOL[arch], err


# B, Hq, Hkv, Sq, Skv, D, window, softcap, offsets: decode (split) forms, with
# offsets whose live tiles are fewer than the static grid's splits (the last
# splits empty), an early offset in a long cache, and a prefill
DEVICE_OFFSET_CASES = [
    (8, 16, 8, 1, 545, 128, None, 0.0, (0, 63, 300, 543)),    # qwen3's decode
    (8, 16, 8, 1, 8192, 128, None, 0.0, (4095, 8191)),        # qwen3, a long cache
    (1, 48, 8, 1, 4625, 128, 4096, 0.0, (4096, 4500, 4623)),  # mixtral's window run
    (1, 16, 8, 1, 2048, 256, 1024, 50.0, (100, 1100, 2047)),  # gemma2 local
    (2, 8, 2, 40, 100, 64, 16, 0.0, (0, 50)),                  # a prefill over a cache
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DEVICE_OFFSET_CASES)
def test_flash_attention_reads_its_offset_from_device_memory(dev, case, dtype):
    """K4 with the offset a 0-d int32 tensor on the card against the same
    call with a host offset and against ``attention_ref``, each within the
    bf16 bound (the decode form's splits differ: the static grid); the
    decode form also against ``flash_decode_plain`` on the same offset."""
    from repro_torch.kernels import flash_attention as FA

    b, hq, hkv, sq, skv, d, window, cap, offsets = case
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g).mul(0.5).to(dev, dtype)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    kw = dict(causal=True, window=window, softcap=cap)
    for off in offsets:
        at = torch.tensor(off, dtype=torch.int32, device=dev)
        got = flash_attention(q, k, v, q_offset=at, **kw)
        host = flash_attention(q, k, v, q_offset=off, **kw)
        want = attention_ref(q, k, v, q_offset=off, **kw)
        tol = 3e-5 + (2.0 ** -7 * want.float().abs()
                      + 2.0 ** -8 * attention_ref(q.float(), k.float(), v.float().abs(),
                                                  q_offset=off, **kw)
                      if dtype == torch.bfloat16 else 0.0)
        for other in (host, want):
            err = (got.float() - other.float()).abs()
            assert bool((err <= 2 * tol).all()), (off, float((err - 2 * tol).max()))
        if form(q, k) == "bf16-decode":
            splits, _ = FA.decode_splits(b, hkv, FA.static_tiles(sq, skv, window),
                                         sm_count(dev.index))
            plain = FA.flash_decode_plain(q, k, v, splits=splits, q_offset=at, **kw)
            err = (got.float() - plain.float()).abs()
            assert bool((err <= tol).all()), (off, float((err - tol).max()))


def _bf16_reduced(arch):
    import dataclasses

    return dataclasses.replace(get_arch(arch).reduced(), param_dtype="bfloat16",
                               compute_dtype="bfloat16")


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b", "gemma2-9b"])
def test_decode_graph_replays_bit_for_bit_and_counts_its_launches(dev, arch):
    """Two replays of one captured step from the same snapshot of the caches
    give the same bits; the warm-up and the capture each count one step's
    K4/K5/K6 calls (by form) on the wrappers, the captured step's launches
    are those, and a replay adds them to the graph's stats and leaves the
    wrappers' counts alone."""
    from repro_torch.core.program import launch_counts
    from repro_torch.launch.serve_lm import DecodeGraph
    from repro_torch.models.attention import KVCache

    cfg = _bf16_reduced(arch)
    params = M.init(torch.Generator(device=dev).manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 24), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    caches = M.make_caches(cfg, 2, 30, dev)
    M.prefill(params, cfg, prompts, caches)
    kinds = M.layer_kinds(cfg)
    n_attn = sum(k in M._ATTN_KINDS for k in kinds)
    n_ssm, n_rwkv = kinds.count(MAMBA2), kinds.count(RWKV6)
    step = {k: n for k, n in (("flash_attention", n_attn), ("flash_attention/bf16-decode", n_attn),
                              ("ssd_scan", n_ssm), ("ssd_scan/decode", n_ssm),
                              ("rwkv6_scan", n_rwkv), ("rwkv6_scan/decode", n_rwkv)) if n}
    before = launch_counts()
    graph = DecodeGraph(cfg, params, caches, prompts[:, -1:], 24)
    captured = launch_counts()
    assert graph.captured_launches == step
    assert {k: n - before[k] for k, n in captured.items() if n != before[k]} == {
        k: 2 * n for k, n in step.items()}  # the warm-up's and the capture's calls
    snap = [t.clone() for c in caches for t in c]
    first = graph.step(prompts[:, -1:]).clone()
    assert launch_counts() == captured and graph.replays == 1
    assert graph.replay_launches == step
    after = [t.clone() for c in caches for t in c]
    for t, u in zip((t for c in caches for t in c), snap):
        t.copy_(u)
    graph.seek(24)
    again = graph.step(prompts[:, -1:])
    assert torch.equal(again, first)
    assert all(torch.equal(t, u) for t, u in zip((t for c in caches for t in c), after))
    assert int(graph.position) == graph.pos == 25
    assert any(isinstance(c, KVCache) for c in caches) == (n_attn > 0)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "stablelm-3b"])
def test_qwen3_full_width_generate_captured_matches_eager(dev, arch):
    """qwen3-0.6b and stablelm-3b at full width and depth: ``generate``
    through the captured step against the eager step, tokens and logits
    (within ``chip_smoke.LM_LOGIT_TOL``; the decode form's splits come from
    the cache in one and from the offset in the other), and the same
    launches: captured, the wrappers count the prefill, the warm-up and the
    capture, and the 8 replays the other steps."""
    import chip_smoke
    from repro_torch.launch import serve_lm
    from repro_torch.launch.serve_lm import generate

    cfg = get_arch(arch)
    g = torch.Generator(device=dev).manual_seed(0)
    params = M.init(g, cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 64), generator=g, device=dev)
    runs = {}
    for capture in (True, False):
        flash_attention.launches, flash_attention.forms = 0, dict.fromkeys(flash_attention.forms, 0)
        serve_lm.stats.reset()
        toks, _, logits = generate(cfg, params, prompts, 73, 8, return_logits=True,
                                   capture=capture)
        replayed = serve_lm.stats.replay_launches
        runs[capture] = (toks, logits, flash_attention.launches + replayed.get(
            "flash_attention", 0), {f: n + replayed.get(f"flash_attention/{f}", 0)
                                    for f, n in flash_attention.forms.items()})
        assert serve_lm.stats.replays == (8 if capture else 0)
        assert flash_attention.launches == cfg.n_layers * (3 if capture else 9)
    (ta, la, na, fa), (tb, lb, nb, fb) = runs[True], runs[False]
    # the captured path's launches also count its warm-up and capture calls
    assert na == nb + 2 * cfg.n_layers == cfg.n_layers * 11
    assert fa["bf16-decode"] == fb["bf16-decode"] + 2 * cfg.n_layers
    tol = chip_smoke.LM_LOGIT_TOL[arch]
    for row in range(2):
        diff = (ta[row] != tb[row]).nonzero()
        n_same = int(diff[0]) if len(diff) else ta.shape[1]
        err = float((la[row, :n_same + 1] - lb[row, :n_same + 1]).abs().max())
        assert err <= tol, (row, err)
        if n_same < ta.shape[1]:  # only at the eager run's near-tie
            top2 = torch.topk(lb[row, n_same], 2).values
            assert float(top2[0] - top2[1]) <= 2 * tol


def test_decode_graph_raises_before_a_replay_past_the_cache(dev):
    from repro_torch.launch.serve_lm import DecodeGraph

    cfg = _bf16_reduced("qwen3-0.6b")
    params = M.init(torch.Generator(device=dev).manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab, (2, 8), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    caches = M.make_caches(cfg, 2, 9, dev)
    M.prefill(params, cfg, prompts, caches)
    graph = DecodeGraph(cfg, params, caches, prompts[:, -1:], 8)
    graph.step(prompts[:, -1:])  # the last row
    launches, snap = flash_attention.launches, [t.clone() for c in caches for t in c]
    with pytest.raises(ValueError, match="cannot write 1 rows at cache_len 9"):
        graph.step(prompts[:, -1:])
    torch.cuda.synchronize()
    assert flash_attention.launches == launches and int(graph.position) == 9
    assert graph.replays == 1
    assert all(torch.equal(t, u) for t, u in zip((t for c in caches for t in c), snap))


def _scan_close(got, want, dtype):
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 + 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=rtol)


def _ssd_inputs(dev, b, s, h, p, g, n, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((b, s, h, p), generator=gen) * 0.5).to(dev, dtype)
    dt = (torch.randn((b, s, h), generator=gen) * 0.3).abs().add(0.01).to(dev)
    a = -(torch.randn((h,), generator=gen) * 2.0).abs().add(0.1).to(dev)
    bm, cm = ((torch.randn((b, s, g, n), generator=gen) * 0.5).to(dev, dtype)
              for _ in range(2))
    h0 = (torch.randn((b, h, p, n), generator=gen) * 0.5).to(dev)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (2, 100, 4, 64, 2, 64),  # two chunks, the second ragged, P = N = 64
    (1, 1, 6, 64, 3, 64),  # a decode step
    (2, 130, 6, 8, 3, 16),  # narrow heads, three chunks
    (1, 64, 2, 40, 1, 24),  # P, N off the tile
])
def test_ssd_kernel_matches_plain_version(dev, case, dtype):
    x, dt, a, bm, cm, h0 = _ssd_inputs(dev, *case, dtype)
    before = ssd_scan.launches
    for init in (None, h0):
        y, h = ops.ssd(x, dt, a, bm, cm, init_state=init, impl="auto")
        want_y, want_h = ssd_scan_plain(x, dt, a, bm, cm, init_state=init)
        assert y.dtype == dtype and h.dtype == torch.float32
        _scan_close(y, want_y, dtype)
        _scan_close(h, want_h, torch.float32)
    assert ssd_scan.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [70, 100, 130, 1])
def test_ssd_kernel_writes_the_state_in_place_and_reads_views(dev, s, dtype):
    """Both forms (decode at S = 1, prefill at ragged S) through strided
    views of one conv output, the state updated in place, equal the calls on
    contiguous copies; each call counted under its form."""
    b, h, p, g, n = 2, 4, 64, 2, 64
    gen = torch.Generator().manual_seed(1)
    conv = torch.randn((b, s, h * p + 2 * g * n), generator=gen).to(dev, dtype)
    x = conv[..., :h * p].unflatten(-1, (h, p))  # strided views, as mamba_apply has
    bm = conv[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cm = conv[..., h * p + g * n:].unflatten(-1, (g, n))
    _, dt, a, _, _, h0 = _ssd_inputs(dev, b, s, h, p, g, n, dtype)
    want_y, want_h = ssd_scan(x.contiguous(), dt, a, bm.contiguous(), cm.contiguous(),
                              init_state=h0)
    state = h0.clone()
    before = dict(ssd_scan.forms)
    y, got_h = ssd_scan(x, dt, a, bm, cm, init_state=state, out_state=state)
    assert got_h is state and torch.equal(y, want_y) and torch.equal(state, want_h)
    kind = SS.form(s)
    assert ssd_scan.forms[kind] == before[kind] + 1
    _scan_close(y, ssd_scan_plain(x, dt, a, bm, cm, init_state=h0)[0], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (8, 1, 112, 64, 2, 64),  # zamba2's decode shape, P = N = 64
    (3, 1, 6, 40, 3, 24),  # P, N off the tile
    (2, 1, 5, 17, 1, 30),  # N not a multiple of 4: no vector loads
])
def test_ssd_decode_form_matches_plain_version(dev, case, dtype):
    x, dt, a, bm, cm, h0 = _ssd_inputs(dev, *case, dtype)
    for init in (None, h0):
        y, h = ssd_scan(x, dt, a, bm, cm, init_state=init)
        want_y, want_h = ssd_scan_plain(x, dt, a, bm, cm, init_state=init)
        _scan_close(y, want_y, dtype)
        _scan_close(h, want_h, torch.float32)


def test_ssd_kernel_refuses_what_it_does_not_take(dev):
    x, dt, a, bm, cm, h0 = _ssd_inputs(dev, 1, 8, 2, 16, 1, 16, torch.float32)
    with pytest.raises(TypeError, match="all f32 or all bf16"):
        ssd_scan(x.half(), dt, a, bm.half(), cm.half())
    with pytest.raises(TypeError, match="dt and a in f32"):
        ssd_scan(x, dt.double(), a, bm, cm)
    with pytest.raises(ValueError, match="1 to 64"):
        wide = x.repeat(1, 1, 1, 5)
        ssd_scan(wide, dt, a, bm, cm)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a, bm, cm)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_scan(x, dt.cpu(), a, bm, cm)
    with pytest.raises(ValueError, match="contiguous f32"):
        ssd_scan(x, dt, a, bm, cm, init_state=h0.transpose(2, 3).contiguous().transpose(2, 3))


def _rwkv_inputs(dev, b, s, h, kd, vd, dtype, seed=0, w_lo=0.15):
    gen = torch.Generator().manual_seed(seed)
    r, k = ((torch.randn((b, s, h, kd), generator=gen) * 0.5).to(dev, dtype)
            for _ in range(2))
    v = (torch.randn((b, s, h, vd), generator=gen) * 0.5).to(dev, dtype)
    w = (torch.sigmoid(torch.randn((b, s, h, kd), generator=gen)) * 0.8 + w_lo).to(dev)
    u = (torch.randn((h, kd), generator=gen) * 0.5).to(dev)
    s0 = (torch.randn((b, h, kd, vd), generator=gen) * 0.5).to(dev)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    (2, 100, 4, 64, 64, 64),  # two chunks, the second ragged
    (1, 1, 4, 64, 64, 64),  # a decode step: floor −88
    (2, 130, 3, 8, 16, 32),  # chunk 32: the kernel's tile follows it
    (1, 80, 2, 24, 40, 64),  # K, V off the tile
    (1, 70, 2, 17, 30, 64),  # rows not whole 16-byte copies: element copies
])
def test_rwkv6_kernel_matches_plain_version(dev, case, dtype):
    *shape, chunk = case
    r, k, v, w, u, s0 = _rwkv_inputs(dev, *shape, dtype)
    before = rwkv6_scan.launches
    for init in (None, s0):
        y, st = ops.rwkv6(r, k, v, w, u, init_state=init, chunk=chunk, impl="auto")
        want_y, want_s = rwkv6_scan_plain(r, k, v, w, u, init_state=init, chunk=chunk)
        assert y.dtype == dtype and st.dtype == torch.float32
        _scan_close(y, want_y, dtype)
        _scan_close(st, want_s, torch.float32)
    assert rwkv6_scan.launches == before + 2


def test_rwkv6_kernel_floors_the_decay_as_the_plain_version(dev):
    """Decays down to e^-5, below the e^(−88/64) floor of a 64-step chunk."""
    r, k, v, _, u, s0 = _rwkv_inputs(dev, 2, 100, 4, 64, 64, torch.float32)
    w = torch.exp(-5.0 * torch.rand(r.shape, generator=torch.Generator().manual_seed(3))
                  ).to(dev)
    y, st = rwkv6_scan(r, k, v, w, u, init_state=s0)
    want_y, want_s = rwkv6_scan_plain(r, k, v, w, u, init_state=s0)
    assert bool(torch.isfinite(y).all())
    _scan_close(y, want_y, torch.float32)
    _scan_close(st, want_s, torch.float32)


def test_rwkv6_kernel_writes_the_state_in_place(dev):
    r, k, v, w, u, s0 = _rwkv_inputs(dev, 2, 70, 4, 64, 64, torch.bfloat16)
    want_y, want_s = rwkv6_scan(r, k, v, w, u, init_state=s0)
    state = s0.clone()
    y, st = rwkv6_scan(r, k, v, w, u, init_state=state, out_state=state)
    assert st is state and torch.equal(y, want_y) and torch.equal(state, want_s)


def test_rwkv6_kernel_refuses_what_it_does_not_take(dev):
    r, k, v, w, u, s0 = _rwkv_inputs(dev, 1, 8, 2, 16, 16, torch.float32)
    with pytest.raises(TypeError, match="all f32 or all bf16"):
        rwkv6_scan(r.half(), k.half(), v.half(), w, u)
    with pytest.raises(TypeError, match="w and u in f32"):
        rwkv6_scan(r, k, v, w.bfloat16(), u)
    with pytest.raises(ValueError, match="1 to 64"):
        rwkv6_scan(r, k, v.repeat(1, 1, 1, 5), w, u)
    with pytest.raises(ValueError, match="CUDA device"):
        rwkv6_scan(r, k, v, w, u.cpu())
    with pytest.raises(ValueError, match="contiguous f32"):
        rwkv6_scan(r, k, v, w, u, out_state=s0.double())


def test_hash_aggregate_overflow_counts_raw_lanes_under_duplicates(dev):
    """64 keys × 5 shuffled copies into 16 slots, 16 probes: the 48 keys that
    find no slot overflow as 240 raw lanes, not as their partials."""
    g = torch.Generator().manual_seed(0)
    keys = torch.arange(64, dtype=torch.int32).repeat(5)[torch.randperm(320, generator=g)]
    vals = torch.ones((320, 1), dtype=torch.int32)
    got = HK.hash_aggregate(keys.to(dev), vals.to(dev), 16, max_probes=16)
    want = HK.hash_aggregate_plain(keys, vals, 16, max_probes=16)
    assert int(got[2]) == int(want[2]) == 240
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("case", ["overflow", "short_tiles"])
def test_hash_aggregate_repeated_calls_match_plain_version(dev, case):
    """Every CTA counts its compacted lanes into a word that the kernel
    zeroes; a count added before every CTA has passed the zeroing would
    lose lanes at random.  The two cases where tiles are shortest (the
    320-lane overflow case; 2^16 distinct keys with one copy in four
    repeated, about 128 lanes a CTA, into 2^17 slots), each called 100
    times, and every table equal to the plain version's."""
    g = torch.Generator().manual_seed(2)
    if case == "overflow":
        keys = torch.arange(64, dtype=torch.int32).repeat(5)[torch.randperm(320, generator=g)]
        cap, probes = 16, 16
    else:
        keys = torch.randperm(1 << 16, generator=g).to(torch.int32)
        keys = torch.cat([keys, keys[: 1 << 14]])[torch.randperm(5 << 14, generator=g)]
        cap, probes = 1 << 17, 16
    vals = torch.ones((keys.shape[0], 1), dtype=torch.int32)
    want = HK.hash_aggregate_plain(keys, vals, cap, max_probes=probes)
    keys, vals = keys.to(dev), vals.to(dev)
    for _ in range(100):
        got = HK.hash_aggregate(keys, vals, cap, max_probes=probes)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def test_hash_aggregate_hot_key_in_one_launch_with_no_host_sync(dev):
    """A quarter of 2^22 lanes on one key beside unique keys: slot for slot
    the plain version's table, one launch, no host sync (the sync debug mode
    raises on any), and the rounds counted on the card."""
    n = 1 << 22
    g = torch.Generator().manual_seed(1)
    hot = torch.rand(n, generator=g) < 0.25
    keys = torch.where(hot, 7, torch.randperm(n, generator=g).to(torch.int32) + 1000)
    keys = keys.to(torch.int32).to(dev)
    vals = torch.ones((n, 1), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    launches, rounds = HK.hash_aggregate.launches, int(HK.hash_aggregate.rounds)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = HK.hash_aggregate(keys, vals, 1 << 23, max_probes=64)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert HK.hash_aggregate.launches == launches + 1
    ran = int(HK.hash_aggregate.rounds) - rounds
    lanes = HK.hash_aggregate.lanes.tolist()
    assert 1 <= ran < 64 and lanes[ran] == 0 and lanes[0] < n
    want = HK.hash_aggregate_plain(keys, vals, 1 << 23, max_probes=64)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[1][got[0] == 7].sum()) == int(hot.sum())


@pytest.mark.parametrize("v", [1, 3, 13_000])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reducer", ["sum", "prod", "min", "max"])
def test_hash_aggregate_hot_keys_match_plain_version(dev, reducer, dtype, v):
    """Hot keys beside rare ones and dead lanes, merged into an init= table
    that holds keys already; V = 13,000 leaves no room for the CTA table.
    Integer results, min and max exact; float sums and products within
    1e-5 of the magnitudes' sum."""
    n = 6000 if v < 100 else 60
    g = torch.Generator().manual_seed(v)
    keys = torch.where(torch.rand(n, generator=g) < 0.4,
                       torch.randint(0, 3, (n,), generator=g),
                       torch.randint(-500, 500, (n,), generator=g)).to(torch.int32)
    keys[torch.rand(n, generator=g) < 0.1] = HK.EMPTY_KEY
    if reducer == "prod":
        raw = torch.where(torch.rand((n, v), generator=g) < 0.5, 1.0, -1.0)
    else:
        raw = torch.randint(-8, 9, (n, v), generator=g).float()
    vals = raw.to(dtype).to(dev)
    keys = keys.to(dev)
    init = HK.hash_aggregate_plain(keys[: n // 3], vals[: n // 3], 2048, reducer=reducer,
                                   max_probes=16)
    got = HK.hash_aggregate(keys, vals, 2048, reducer=reducer, init=init, max_probes=16)
    want = HK.hash_aggregate_plain(keys, vals, 2048, reducer=reducer, init=init,
                                   max_probes=16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    if dtype == torch.int32 or reducer in ("min", "max"):
        assert torch.equal(got[1], want[1])
    else:
        mag = HK.hash_aggregate_plain(keys, vals.abs(), 2048, max_probes=16)[1]
        assert bool(((got[1] - want[1]).abs() <= 1e-5 * (mag + init[1].abs())).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (8, 32, 64, 64),  # rwkv6's decode shape
    (3, 5, 24, 40),  # K, V off the tile
    (2, 3, 17, 30),  # V not a multiple of 4: no vector loads
])
def test_rwkv6_decode_form_matches_plain_version(dev, shape, dtype):
    """One step (floor −88), from a zero state and from one, the state
    written in place; counted under the decode form."""
    b, h, kd, vd = shape
    r, k, v, w, u, s0 = _rwkv_inputs(dev, b, 1, h, kd, vd, dtype)
    before = dict(rwkv6_scan.forms)
    for init in (None, s0):
        y, st = rwkv6_scan(r, k, v, w, u, init_state=init)
        want_y, want_s = rwkv6_scan_plain(r, k, v, w, u, init_state=init)
        _scan_close(y, want_y, dtype)
        _scan_close(st, want_s, torch.float32)
    state = s0.clone()
    y, st = rwkv6_scan(r, k, v, w, u, init_state=state, out_state=state)
    assert st is state and torch.equal(y, rwkv6_scan(r, k, v, w, u, init_state=s0)[0])
    assert rwkv6_scan.forms["decode"] == before["decode"] + 4
    assert rwkv6_scan.forms["prefill"] == before["prefill"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_decode_chained_equals_one_prefill(dev, dtype):
    """16 decode steps, each from the last state in place, against one
    prefill of the same 16 steps: within twice the prefill's derived bound
    (``chip_smoke.rwkv6_bound``), plus a bf16 step of y for bf16."""
    import chip_smoke

    r, k, v, w, u, s0 = _rwkv_inputs(dev, 2, 16, 4, 64, 64, dtype)
    before = dict(rwkv6_scan.forms)
    y_pre, s_pre = rwkv6_scan(r, k, v, w, u, init_state=s0)
    state = s0.clone()
    ys = [rwkv6_scan(r[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1], w[:, i:i + 1], u,
                     init_state=state, out_state=state)[0] for i in range(16)]
    assert rwkv6_scan.forms["prefill"] == before["prefill"] + 1
    assert rwkv6_scan.forms["decode"] == before["decode"] + 16
    (by, bs), _, _ = chip_smoke.rwkv6_bound(r, k, v, w, u, s0)
    y_dec = torch.cat(ys, 1)
    tol_y = 2 * by + (2.0 ** -7 * y_pre.double().abs() if dtype == torch.bfloat16 else 0)
    assert bool(((y_dec.double() - y_pre.double()).abs() <= tol_y).all())
    assert bool(((state.double() - s_pre.double()).abs() <= 2 * bs).all())


def test_rwkv6_prefill_form_at_the_floor_in_bf16(dev):
    """Decays down to e^-5 in the bf16 model: λ reaches −88 within a chunk;
    the prefill form stays finite and within its bound of the floored
    float64 oracle (``chip_smoke.rwkv6_bound``, one bf16 step of y more)."""
    import chip_smoke
    from repro_torch.kernels.ref import rwkv6_ref

    r, k, v, _, u, s0 = _rwkv_inputs(dev, 2, 128, 4, 64, 64, torch.bfloat16)
    w = torch.exp(-5.0 * torch.rand(r.shape, generator=torch.Generator().manual_seed(3))
                  ).to(dev)
    y, st = rwkv6_scan(r, k, v, w, u, init_state=s0)
    (by, bs), _, logw = chip_smoke.rwkv6_bound(r, k, v, w, u, s0)
    f64 = [t.double() for t in (r, k, v, u, s0)]
    want_y, want_s = rwkv6_ref(*f64[:3], torch.exp(logw), f64[3], init_state=f64[4])
    assert bool(torch.isfinite(y).all())
    assert bool(((y.double() - want_y).abs() <= 1.1 * by + 2.0 ** -7 * want_y.abs()).all())
    assert bool(((st.double() - want_s).abs() <= 1.1 * bs).all())


# -- programs as CUDA graph replays ---------------------------------------------


def _program_jobs(sess, mode, engine="pallas"):
    """The six jobs at small sizes, through ``sess`` in ``mode``."""
    from repro_torch.core.algorithms import (
        counts_dict, estimate_pi, kmeans, knn, wordcount)
    from repro_torch.data.synthetic import zipf_corpus

    lines, _ = zipf_corpus(256, 16, 700, seed=2)
    pts, _ = cluster_points(20_000, 3, 5, seed=1)
    gpts, _ = cluster_points(5_000, 3, 4, seed=2)
    kw = dict(mode=mode, session=sess)
    wc = wordcount(lines, engine=engine, iters=2, unroll=2, **kw)
    return {
        "pi": estimate_pi(1 << 20, engine=engine, **kw),
        "wordcount": counts_dict(wc.counts),
        "pagerank": pagerank(rmat_edges(10, 8, seed=3), 1024, tol=0.0, max_iters=5,
                             engine=engine, unroll=5, **kw),
        "kmeans": kmeans(pts, 5, init_centers=pts[:5].copy(), tol=0.0, max_iters=5,
                         engine=engine, unroll=5, **kw),
        "gmm": gmm_em(gpts, 4, init_mu=gpts[:4].copy(), tol=0.0, max_iters=5,
                      engine=engine, unroll=5, **kw),
        "knn": knn(pts, np.zeros(3, np.float32), 32, **kw),
    }


def test_program_jobs_run_as_captured_graph_replays(dev):
    """The six jobs in ``mode="program"`` on the card: every dispatch a
    replay of a captured graph, the kernels recorded in the graphs
    (K1 for PageRank, k-means and GMM, K2 for wordcount), the results those
    of ``per_op`` on the card (π and counts exactly, the float jobs within
    the per-op parity tolerances)."""
    sess = BlazeSession(device=dev)
    got = _program_jobs(sess, "program")
    want = _program_jobs(BlazeSession(device=dev), "per_op")
    st = sess.stats
    assert st.graph_captures >= 6 and st.graph_replays == st.program_dispatches
    assert st.graph_launches.get("segment_reduce", 0) > 0
    assert st.graph_launches.get("hash_aggregate", 0) > 0
    assert got["pi"] == want["pi"] and got["wordcount"] == want["wordcount"]
    assert np.abs(got["pagerank"].scores - want["pagerank"].scores).max() <= 1e-5
    assert np.abs(got["kmeans"].centers - want["kmeans"].centers).max() <= 1e-4
    assert abs(got["kmeans"].inertia - want["kmeans"].inertia) <= 1e-4 * want["kmeans"].inertia
    g, w = got["gmm"], want["gmm"]
    assert abs(g.log_likelihood - w.log_likelihood) <= 1e-5 * abs(w.log_likelihood)
    for name in ("alpha", "mu", "sigma"):
        np.testing.assert_allclose(getattr(g, name), getattr(w, name), atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.sort(got["knn"].distances),
                               np.sort(want["knn"].distances), rtol=1e-6)
    assert got["pagerank"].collectives_per_iter == 2 and got["gmm"].collectives_per_iter == 2


def test_program_runs_k3_inside_a_captured_graph(dev):
    """Fig. 6's hand-fused step (K3's stream form, a cooperative launch) as a
    program: 5 Lloyd steps in one replay equal 5 eager steps bit for bit
    (the stream form adds in a fixed order)."""
    pts, _ = cluster_points(200_000, 3, 5, seed=0)
    x = torch.from_numpy(pts).to(dev)
    c0 = x[:5].clone()

    def lloyd(c):
        s = ops.kmeans_assign(x, c)[1]
        return s[:, :3] / torch.clamp(s[:, 3:], min=1.0)

    sess = BlazeSession(device=dev)
    prog = sess.program(lambda ctx, s: {"c": lloyd(s["c"])})
    before = kmeans_assign.launches
    out = prog({"c": c0}, 5)
    c = c0
    for _ in range(5):
        c = lloyd(c)
    assert torch.equal(out["c"], c)
    assert prog.stats.captures == 1 and prog.stats.replays == 1
    assert prog.stats.replay_launches["kmeans_assign"] == 5
    assert kmeans_assign.launches - before == 1 + 1 + 5 + 5  # discovery, warm-up, capture, eager


def test_program_state_is_copied_out_of_the_graph(dev):
    """run_loop hands back copies: a later replay leaves an earlier result
    as it was, and a second run from the same state replays without a new
    capture."""
    sess = BlazeSession(device=dev)
    src = sess.distribute(np.arange(64, dtype=np.float32))

    def step(ctx, s):
        t = ctx.map_reduce(src, lambda i, x, emit: emit(i % 4, x), "sum",
                           torch.zeros(4, device=dev), engine="pallas")
        return {"acc": s["acc"] + t}

    prog = sess.program(step)
    s0 = {"acc": torch.zeros(4, device=dev)}
    a, info = sess.run_loop(prog, s0, max_iters=3, unroll=3)
    a_copy = a["acc"].clone()
    b, _ = sess.run_loop(prog, a, max_iters=3, unroll=3)
    assert torch.equal(a["acc"], a_copy) and torch.equal(b["acc"], 2 * a_copy)
    assert prog.stats.captures == 1 and prog.stats.replays == 2
    assert info.compiles == 1


def test_program_graphs_share_one_pool(dev):
    """A program's graphs (here ``u`` = 3 and 1) allocate from one pool,
    the reservation of all of them is counted, and replaying them in any
    order gives each its own exact result (integer-valued f32 sums)."""
    sess = BlazeSession(device=dev)
    src = sess.distribute(np.arange(1 << 16, dtype=np.float32) % 7)

    def step(ctx, s):
        t = ctx.map_reduce(src, lambda i, x, emit: emit(i % 4, x), "sum",
                           torch.zeros(4, device=dev), engine="pallas")
        return {"acc": s["acc"] + t}

    prog = sess.program(step)
    per_iter = np.zeros(4)
    np.add.at(per_iter, np.arange(1 << 16) % 4, np.arange(1 << 16) % 7)
    s0 = {"acc": torch.zeros(4, device=dev)}
    for u in (3, 1, 3, 1, 1, 3):
        out = prog(s0, u)
        np.testing.assert_array_equal(out["acc"].cpu().numpy(), u * per_iter)
    pools = {g.graph.pool() for g in prog._graphs.values()}
    assert prog.stats.captures == 2 and len(pools) == 1
    assert prog.stats.pool_reserved_bytes > 0
    assert sess.stats.graph_pool_reserved_bytes == prog.stats.pool_reserved_bytes


def test_program_int8_residual_and_hash_tables_carry_across_replays(dev):
    sess = BlazeSession(device=dev, n_shards=4)
    rows = np.random.RandomState(2).randn(256, 2).astype(np.float32)
    pts = sess.distribute(rows)
    hm = sess.make_dist_hashmap(64, (), torch.float32, "sum")

    def step(ctx, s):
        inc = ctx.map_reduce(pts, lambda i, x, emit: emit(i % 8, x[1]), "sum",
                             torch.zeros(8, device=dev), wire="int8", engine="pallas")
        ctx.map_reduce(pts, lambda i, x, emit: emit(i % 5, x[0]), "sum", hm,
                       engine="pallas")
        return {"acc": s["acc"] + inc}

    prog = sess.program(step)
    state = {"acc": torch.zeros(8, device=dev)}
    for u in (1, 1, 3):
        state = prog(state, u)
    exact = np.zeros(8)
    np.add.at(exact, np.arange(256) % 8, rows[:, 1].astype(np.float64))
    (res,) = prog.export_carry(state)["residual"]
    np.testing.assert_allclose(state["acc"].cpu().numpy() + res.sum(0).cpu().numpy(),
                               5 * exact, rtol=1e-4, atol=1e-3)
    want = np.zeros(5)
    np.add.at(want, np.arange(256) % 5, rows[:, 0].astype(np.float64))
    got = prog.hash_result(hm).to_dict()
    np.testing.assert_allclose([float(got[k]) for k in range(5)], 5 * want,
                               rtol=1e-5, atol=1e-4)
    assert prog.stats.captures == 2 and hm.size() == 0


def test_program_capture_that_syncs_raises_naming_the_op(dev):
    """Glue that reads a value on the host cannot be captured: the capture
    raises and names the last op; the program never runs without a graph."""
    sess = BlazeSession(device=dev)
    src = sess.distribute(np.arange(64, dtype=np.float32))

    def step(ctx, s):
        t = ctx.map_reduce(src, lambda i, x, emit: emit(i % 4, x), "sum",
                           torch.zeros(4, device=dev))
        if float(t.sum()) > 0:  # a host sync
            return {"acc": s["acc"] + t}
        return s

    prog = sess.program(step)
    with pytest.raises(RuntimeError, match=r"capture.*map_reduce sum"):
        prog({"acc": torch.zeros(4, device=dev)}, 1)
    assert prog.stats.replays == 0


# -- tuning candidates and streams on the card ---------------------------------------


def _tune_shapes():
    """(n, v, k): k-means' per-op and program rows, GMM's 9-wide rows, a
    shared-only key range, PageRank's global form, the register form's key
    limit."""
    return [(50_003, 4, 5), (50_003, 5, 5), (20_001, 9, 5), (30_001, 4, 64),
            (40_001, 1, 1 << 20), (70_001, 6, 8)]


@pytest.mark.parametrize("n,v,k", _tune_shapes())
def test_segment_reduce_every_tuning_candidate_matches_plain_version(dev, n, v, k):
    """Each K1 form at each measured CTA count: i32 sums exactly, f32 sums
    within 1e-5 of the addends' magnitudes (the atomics' order is free), and
    each call in the form it was asked for."""
    from repro_torch.core import cost

    g = torch.Generator().manual_seed(n + k)
    ids = torch.randint(-3, k + 3, (n,), generator=g, dtype=torch.int32).to(dev)
    ints = torch.randint(-50, 51, (n, v), generator=g, dtype=torch.int32).to(dev)
    x = torch.randn((n, v), generator=g).to(dev)
    want_i = segment_reduce_plain(ids, ints, k)
    want_x = segment_reduce_plain(ids, x, k)
    mag = segment_reduce_plain(ids, x.abs(), k)
    cands = cost.dense_tuning_candidates(k, v, "sum", torch.float32)[1:]
    assert len(cands) == 4 * len(SR.valid_forms(k, v))
    for c in cands:
        before = dict(SR.segment_reduce.forms)
        got = segment_reduce(ids, ints, k, form=c.form, ctas_per_sm=c.ctas_per_sm)
        assert torch.equal(got, want_i), c
        got = segment_reduce(ids, x, k, form=c.form, ctas_per_sm=c.ctas_per_sm)
        assert bool(((got - want_x).abs() <= 1e-5 * mag + 1e-6).all()), c
        assert SR.segment_reduce.forms[c.form] == before[c.form] + 2


@pytest.mark.parametrize("v,key_range", [(1, 40), (1, 1 << 15), (4, 3000)])
def test_hash_aggregate_every_tuning_candidate_matches_plain_version(dev, v, key_range):
    """Each K2 (capacity, probe depth, table of hot keys) candidate: the
    table slot for slot and the overflow as the plain version's, i32 values
    exactly; the table of hot keys changes nothing but the time."""
    from repro_torch.core import cost

    g = torch.Generator().manual_seed(key_range)
    n = 200_003
    keys = torch.randint(0, key_range, (n,), generator=g, dtype=torch.int32)
    keys[::11] = 3  # a hot key
    keys[::17] = HK.EMPTY_KEY
    keys = keys.to(dev)
    vals = torch.randint(-5, 6, (n, v), generator=g, dtype=torch.int32).to(dev)
    for c in cost.hash_tuning_candidates(v, "sum", torch.int32, key_range=key_range)[1:]:
        got = HK.hash_aggregate(keys, vals, c.table_cap, max_probes=c.probe_depth,
                                table_bits=c.table_bits)
        want = HK.hash_aggregate_plain(keys, vals, c.table_cap, max_probes=c.probe_depth)
        for a, b in zip(got, want):
            assert torch.equal(a, b), c
        assert int(got[2]) == 0


def test_invalid_tuned_overrides_raise_on_the_card(dev):
    ids = torch.zeros(64, dtype=torch.int32, device=dev)
    vals = torch.ones((64, 2), device=dev)
    with pytest.raises(ValueError, match="not valid"):
        segment_reduce(ids, vals, 9, form="registers")
    with pytest.raises(ValueError, match="not valid"):
        segment_reduce(ids, vals, 1 << 20, form="shared")
    with pytest.raises(ValueError, match="table_bits"):
        HK.hash_aggregate(ids, vals, 128, table_bits=HK.table_bits(2) + 1)


def test_tuned_program_matches_untuned_on_the_card(dev):
    """A tuned k-means program measures each candidate once, runs K1 in the
    winner's form inside its graph, and gives the untuned program's centres
    (integer-valued points: exact sums in any order)."""
    from repro_torch.core.algorithms.kmeans import _program_step
    from repro_torch.core import cost

    pts = np.random.RandomState(0).randint(-4, 5, size=(20_000, 3)).astype(np.float32)
    out = {}
    for tune in (False, True):
        sess = BlazeSession(device=dev)
        step, state0 = _program_step(sess.distribute(pts), 5, 3, "pallas", "none")
        prog = sess.program(step, tune=tune)
        state, _ = sess.run_loop(prog, state0(torch.as_tensor(pts[:5], device=dev)),
                                 max_iters=4, unroll=2)
        out[tune] = state["centers"]
        if tune:
            n_cands = len(cost.dense_tuning_candidates(5, 5, "sum", torch.float32))
            assert sess.stats.tune_measurements == n_cands == len(prog.tune_walls)
            (_, cfg), = sess.tuning.items()
            assert prog.plan.mapreduce_nodes()[0].tuned == cfg
            for ov, wall, launches in prog.tune_walls:
                (c,) = ov.values()
                if c.engine == "pallas":
                    assert launches.get(f"segment_reduce/{c.form}", 0) == 1, c
                else:
                    assert launches.get("segment_reduce", 0) == 0
    assert torch.equal(out[False], out[True])


def test_streamed_program_keeps_its_block_buffer_and_restores_in_place(dev, tmp_path):
    """A streamed program's static block buffer and base scalar keep their
    addresses across blocks and epochs (the graph reads them), each block's
    K1 launch is a replay, the result equals the in-memory program's, and a
    restored checkpoint is copied into the carry and input buffers in
    place."""
    from repro_torch.core.algorithms.kmeans import _program_step, _stream_step
    from repro_torch.core.algorithms.wordcount import _program_step as wc_step

    pts = np.random.RandomState(1).randint(-9, 10, size=(10_000, 3)).astype(np.float32)
    sess = BlazeSession(device=dev)
    cv = sess.chunked(pts, block_rows=3000)  # 4 blocks, the last padded
    assert cv.stats()["pinned"] and cv.block_tensor(0).is_pinned()
    c0 = torch.as_tensor(pts[:5], device=dev)
    step, state0 = _stream_step(cv, 5, 3, "pallas", "none", dev)
    prog = sess.program(step)
    state, info = sess.run_stream(prog, state0(c0), max_epochs=1)
    (slot,) = prog._streams.values()
    ptrs = (slot.buf.data_ptr(), slot.base.data_ptr(), slot.staging.data_ptr())
    for prefetch in (True, False):
        state, info = sess.run_stream(prog, state, max_epochs=2, prefetch=prefetch)
        assert (slot.buf.data_ptr(), slot.base.data_ptr(),
                slot.staging.data_ptr()) == ptrs
        assert int(slot.base) == 3 * 3000  # the last block's offset
    assert prog.stats.captures == 1 and prog.stats.replays == 5 * cv.n_blocks
    assert prog.stats.replay_launches["segment_reduce"] == 5 * cv.n_blocks
    mstep, mstate0 = _program_step(sess.distribute(pts), 5, 3, "pallas", "none")
    mem, _ = sess.run_loop(sess.program(mstep), mstate0(c0), max_iters=5)
    assert torch.equal(state["centers"], mem["centers"])

    lines = np.random.RandomState(2).randint(0, 40, size=(4000, 8)).astype(np.int32)
    cl = sess.chunked(lines, block_rows=1024)
    hm = sess.make_dist_hashmap(160, (), torch.int32, "sum")
    wstep, wstate = wc_step(cl, hm, 40, "pallas")
    wprog = sess.program(wstep)
    ws, _ = sess.run_stream(wprog, wstate, max_epochs=2, checkpoint=str(tmp_path),
                            checkpoint_every=1)
    carry = wprog._carry[wprog._last_sig]
    (table,) = carry.tables.values()
    ptrs = [t.data_ptr() for t in (table.keys, table.vals, table.overflow,
                                   *carry.state_in)]
    ws, info = sess.run_stream(wprog, wstate, max_epochs=3, checkpoint=str(tmp_path),
                               checkpoint_every=1, resume=True)
    assert info.resumed_from == 2
    assert [t.data_ptr() for t in (table.keys, table.vals, table.overflow,
                                   *carry.state_in)] == ptrs
    counts = np.bincount(lines.reshape(-1), minlength=40)
    assert wprog.hash_result(hm).to_dict() == {k: 3 * int(c) for k, c in enumerate(counts)}


# -- faults and supervised dispatch on the card ----------------------------------------


@pytest.fixture
def ledger():
    """A disarmed fault registry with a zeroed ledger, before and after."""
    from repro_torch.core import faults

    faults.reset(env=False)
    yield faults
    faults.reset(env=False)


def _k1_k2_step(sess, src, hm, dev):
    """A step with a K2 node (hash target) and a K1 node (dense sum) on
    integer-valued rows, so every engine's sums are exact."""
    def step(ctx, s):
        ctx.map_reduce(src, lambda i, x, emit: emit(x.to(torch.int32) % 97, x), "sum", hm,
                       engine="pallas", key_range=97)
        t = ctx.map_reduce(src, lambda i, x, emit: emit(i % 8, x), "sum",
                           torch.zeros(8, device=dev), engine="pallas")
        return {"acc": s["acc"] + t}

    return step


def test_degraded_program_recaptures_and_matches(dev, ledger):
    """A kernel fault at a replay's dispatch degrades both kernel nodes:
    the program drops its graph, rediscovers the plan with the nodes eager
    and captures again, into the same carry and input buffers; the run
    equals one that was eager from the start, exactly."""
    x = np.arange(1 << 16, dtype=np.float32) % 509

    def run(engine_fault):
        sess = BlazeSession(device=dev)
        hm = sess.make_dist_hashmap(256, (), torch.float32, "sum")
        prog = sess.program(_k1_k2_step(sess, sess.distribute(x), hm, dev))
        state = prog({"acc": torch.zeros(8, device=dev)}, 1)
        carry = prog._carry[prog._last_sig]
        bufs = [*carry.state_in] + [a for t in carry.tables.values()
                                    for a in (t.keys, t.vals, t.overflow)]
        ptrs = [b.data_ptr() for b in bufs]
        if engine_fault:
            ledger.configure("kernel.hash", at=1)
        for _ in range(2):
            state = sess.supervised(lambda s=state: prog(s, 1), program=prog)
        assert [b.data_ptr() for b in bufs] == ptrs
        return sess, prog, state, prog.hash_result(hm)

    sess, prog, state, hm = run(True)
    assert prog.stats.degradations == 1 and prog.stats.graphs_dropped == 1
    assert prog.stats.captures == 2 and sess.stats.degraded_nodes == 1
    assert all(n.engine == "eager" for n in prog.plan.mapreduce_nodes())
    assert "segment_reduce" not in prog.stats.captured_launches[1]
    snap = ledger.snapshot()
    assert snap["balanced"] and snap["dispositions"]["degraded"] == 1
    ledger.reset(env=False)
    _, _, want, want_hm = run(False)
    assert torch.equal(state["acc"], want["acc"])
    assert hm.to_dict() == want_hm.to_dict()


def test_capture_that_raised_leaves_no_graph(dev, ledger):
    """An injected fault inside the first capture (the ``collective``
    point) leaves no graph, no stale context and the sync-debug mode as it
    was; the device is usable and the next capture succeeds."""
    sess = BlazeSession(device=dev)
    src = sess.distribute(np.arange(1 << 12, dtype=np.float32) % 7)

    def step(ctx, s):
        t = ctx.map_reduce(src, lambda i, x, emit: emit(i % 4, x), "sum",
                           torch.zeros(4, device=dev), engine="pallas")
        return {"acc": s["acc"] + t}

    prog = sess.program(step)
    s0 = {"acc": torch.zeros(4, device=dev)}
    debug = torch.cuda.get_sync_debug_mode()
    ledger.configure("collective", at=1)
    with pytest.raises(ledger.TransientFault):
        prog(s0, 1)
    assert not prog._graphs and prog._active is None and prog.stats.captures == 0
    assert torch.cuda.get_sync_debug_mode() == debug
    torch.cuda.synchronize()
    out = prog(s0, 1)  # captures again, fires again (as the reference's
    assert prog.stats.captures == 1  # jit traces again), at=1 is spent
    want = np.zeros(4)
    np.add.at(want, np.arange(1 << 12) % 4, np.arange(1 << 12) % 7)
    np.testing.assert_array_equal(out["acc"].cpu().numpy(), want)
    # supervised, the same fault is retried and recorded so
    ledger.reset(env=False)
    ledger.configure("collective", at=1)
    prog2 = sess.program(step)
    out2, _ = sess.run_loop(prog2, s0, max_iters=1)
    assert torch.equal(out2["acc"], out["acc"]) and prog2.stats.captures == 1
    snap = ledger.snapshot()
    assert snap["balanced"] and snap["dispositions"]["retried"] == 1
    torch.cuda.synchronize()


def test_mid_stream_degrade_replays_the_right_block(dev, ledger):
    """A kernel fault at block 3's dispatch, while block 4 is landing in the
    staging buffer and the prefetch worker decodes block 5 into fresh pinned
    memory (compressed blocks): the program captures again after the copy
    stream drains and replays block 3 from the static buffer.  Every block
    is summed once, exactly as in the fault-free stream."""
    rows = (np.arange(6 * 4096 * 2, dtype=np.float32) % 251).reshape(-1, 2)

    def run(fault):
        sess = BlazeSession(device=dev)
        cv = sess.chunked(rows, 4096, compress=True)  # 6 blocks
        assert cv.n_blocks == 6

        def step(ctx, s):
            t = ctx.map_reduce(cv, lambda i, x, emit: emit(i % 16, x[0] + 2 * x[1]),
                               "sum", torch.zeros(16, device=dev), engine="pallas")
            return {"acc": s["acc"] + t, "blocks": s["blocks"] + 1}

        prog = sess.program(step)
        if fault:
            ledger.configure("kernel.segment", at=3)
        state, info = sess.run_stream(prog, {"acc": torch.zeros(16, device=dev),
                                             "blocks": torch.zeros((), device=dev)},
                                      max_epochs=2)
        return prog, state, info

    prog, state, info = run(True)
    assert info.dispatches == 12 and float(state["blocks"]) == 12
    assert prog.stats.degradations == 1 and prog.stats.captures == 2
    assert ledger.snapshot()["dispositions"]["degraded"] == 1
    ledger.reset(env=False)
    _, want, _ = run(False)
    exact = np.zeros(16)
    np.add.at(exact, np.arange(len(rows)) % 16, rows[:, 0] + 2 * rows[:, 1])
    np.testing.assert_array_equal(want["acc"].cpu().numpy(), 2 * exact)
    assert torch.equal(state["acc"], want["acc"])


# -- the query server on the card ---------------------------------------------


def _serve_datasets(srv):
    from repro_torch.data.synthetic import zipf_corpus

    lines, _ = zipf_corpus(1024, 16, 512, seed=3)
    pts, _ = cluster_points(1 << 16, 3, 5, seed=1)
    srv.register_dataset("edges", rmat_edges(10, 8, seed=3), n_pages=1 << 10)
    srv.register_dataset("lines", lines, vocab_size=512)
    srv.register_dataset("points", pts)


def _strict_phase_1(srv):
    """Run the dispatch of every resident program of ``srv`` (one that has
    dispatched before, with no fault rule armed: a capture synchronises)
    under sync-debug ``"error"``, so a host sync in that phase 1 fails its
    requests.  Returns the count of groups that ran so, ``{"groups": n}``."""
    from repro_torch.core import faults

    strict = {"groups": 0}
    supervised = srv.session.supervised

    def strict_supervised(attempt, *, program=None, **kw):
        if program is None or not program.stats.dispatches or faults.registry.armed:
            return supervised(attempt, program=program, **kw)
        strict["groups"] += 1
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return supervised(attempt, program=program, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    srv.session.supervised = strict_supervised
    return strict


SERVED = (
    ("pagerank", {"engine": "pallas"}),
    ("wordcount", {"engine": "pallas"}),
    ("kmeans", {"engine": "pallas", "k": 5}),
    ("gmm", {"engine": "pallas", "k": 5}),
    ("knn", {"k": 16, "query": [0.5, 0.0, -0.5]}),
    ("pi", {"engine": "pallas", "n_samples": 1 << 16}),
)


def test_served_compiles_equal_distinct_plans_whatever_iters(dev):
    """A request's ``iters`` is not captured: each plan captures one graph
    of one iteration, replayed ``iters`` times, and the server compiles once
    a plan whatever ``iters`` its requests send."""
    from repro_torch.serve import BlazeServer, run_direct

    with BlazeServer(device=dev) as srv:
        _serve_datasets(srv)
        for i in (1, 4, 2, 7, 3):
            for q, p in SERVED[:4]:
                r, _ = srv.submit_and_wait("t", q, {**p, "iters": i, "seed": i % 3})
        assert srv.stats.compiles == srv.session.stats.program_compiles == 4
        for prep in srv._programs.values():
            st = prep.program.stats
            assert st.captures == 1 and list(prep.program._graphs) == [
                (prep.program._last_sig, 1)]
            assert st.replays == st.iterations
        want = run_direct(BlazeSession(device=dev), srv.datasets, "wordcount",
                          {"engine": "pallas", "iters": 3})
        got, meta = srv.submit_and_wait("t", "wordcount", {"engine": "pallas", "iters": 3})
        assert meta["cache"] == "hit"
        np.testing.assert_array_equal(got["keys"], want["keys"])
        np.testing.assert_array_equal(got["counts"], want["counts"])


def test_served_cache_hit_batch_makes_no_host_sync_in_phase_1(dev):
    """A resident program's phase 1 run under sync-debug ``"error"``
    (``_strict_phase_1``): a batch of cache hits of all six queries (their
    per-request state copied from pinned memory) succeeds, every hit having
    run so, and a query whose ``run`` syncs fails with ``QUERY_ERROR`` once
    it is resident."""
    from repro_torch.serve import BlazeServer, PreparedQuery, QuerySpec

    class Syncing(QuerySpec):
        name = "syncing"

        def plan_key(self, params):
            return ("syncing",)

        def prepare(self, res, params):
            from repro_torch.core.algorithms.pi import _program_step

            step, state0 = _program_step(1 << 12, "pallas", res.device)
            prog = res.session.program(step)

            def run(p):
                out = prog(state0, 1)
                float(out["counts"][0])  # a host sync
                return out

            return PreparedQuery(self.plan_key(params), prog.build(state0).hash, prog,
                                 run, lambda dev: {"counts": dev["counts"].cpu().numpy()})

    with BlazeServer(device=dev, max_batch=8) as srv:
        strict = _strict_phase_1(srv)
        _serve_datasets(srv)
        srv.register_query(Syncing())
        for q, p in SERVED:  # first requests capture (not checked)
            srv.submit_and_wait("t", q, {**p, "iters": 2})
        srv.submit_and_wait("t", "syncing", {})
        assert strict["groups"] == 0
        srv.pause_dispatch()
        reqs = [srv.submit(f"t{j}", q, {**p, "iters": 1 + j, "seed": j})
                for j in range(3) for q, p in SERVED]
        srv.resume_dispatch()
        for r in reqs:
            assert r.done.wait(120) and r.error is None, r.error
            assert r.meta["cache"] in ("hit", "dedup")
        assert srv.stats.batched_dispatches >= 1
        assert strict["groups"] == srv.stats.cache_hits > 0
        with pytest.raises(Exception) as ei:
            srv.submit_and_wait("t", "syncing", {})
        assert getattr(ei.value, "code", None) == "QUERY_ERROR"
    assert torch.cuda.get_sync_debug_mode() == 0


def test_dispatcher_thread_works_on_the_session_device(dev):
    from repro_torch.serve import BlazeServer, PreparedQuery, QuerySpec

    seen = {}

    class Where(QuerySpec):
        name = "where"

        def plan_key(self, params):
            return ("where",)

        def prepare(self, res, params):
            from repro_torch.core.algorithms.pi import _program_step

            step, state0 = _program_step(1 << 10, "eager", res.device)
            prog = res.session.program(step)

            def run(p):
                seen["device"] = torch.cuda.current_device()
                seen["locked"] = res.session.lock._is_owned()
                return prog(state0, 1)

            return PreparedQuery(self.plan_key(params), prog.build(state0).hash, prog,
                                 run, lambda dev: {"counts": dev["counts"].cpu().numpy()})

    index = torch.cuda.device_count() - 1
    sess = BlazeSession(device=torch.device("cuda", index))
    with BlazeServer(sess) as srv:
        srv.register_query(Where())
        r, _ = srv.submit_and_wait("t", "where", {})
    assert seen == {"device": index, "locked": True}
    assert int(r["counts"][0]) > 0


def test_served_pallas_kmeans_launches_k1_in_its_graph(dev):
    """A served ``engine: "pallas"`` k-means request runs K1's register form
    inside its graph (counted at capture by ``launch_counts()``, then once a
    replay).  K3 is not on this path: the k-means program's step
    (``kmeans._program_step``) is one ``[K, dim+2]`` MapReduce, as the
    reference's is; fig. 6's hand-fused assignment is the one that runs K3."""
    from repro_torch.core.program import launch_counts
    from repro_torch.serve import BlazeServer

    with BlazeServer(device=dev) as srv:
        _serve_datasets(srv)
        before = launch_counts()
        srv.submit_and_wait("t", "kmeans", {"engine": "pallas", "k": 5, "iters": 3})
        after = launch_counts()
        (prep,) = srv._programs.values()
    grew = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert grew.get("segment_reduce", 0) > 0 and grew.get("segment_reduce/registers", 0) > 0
    assert "kmeans_assign" not in grew
    assert prep.program.stats.captured_launches[1] == {
        "segment_reduce": 1, "segment_reduce/registers": 1}
    assert prep.program.stats.replay_launches["segment_reduce"] == 3


def test_codec_round_trips_card_tensors_bit_for_bit(dev):
    import json

    from repro_torch.serve import decode_payload, encode_payload

    g = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.randn(64, 3, device=dev, generator=g)
    bf16 = f32.to(torch.bfloat16)
    got = decode_payload(json.loads(json.dumps(encode_payload({"f32": f32, "bf16": bf16}))))
    assert got["f32"].tobytes() == f32.cpu().numpy().tobytes()
    assert torch.equal(got["bf16"].view(torch.int16), bf16.cpu().view(torch.int16))


# -- the (node, data) mesh on the card ------------------------------------------


def test_hierarchical_reduce_matches_flat_on_k1_and_k2(dev):
    """On a (2x4) mesh of shards stacked on the card: K1's per-shard
    partials reduced hierarchically equal the flat reduce bit for bit on
    integer-valued rows (every partial and total exact in f32), min and max
    too; K2's tables (never hierarchical) count every token exactly.  Each
    kernel launches once a shard a call."""
    from repro_torch.launch.mesh import make_node_data_mesh

    sess = BlazeSession(mesh=make_node_data_mesh(2, n_shards=8, device=dev))
    g = np.random.RandomState(0)
    rows = g.randint(0, 100, (1 << 14, 4)).astype(np.float32)
    v = sess.distribute(rows)

    def dense(i, x, emit):
        emit(i % 16, x)

    for red in ("sum", "min", "max"):
        t = torch.full((16, 4), {"sum": 0.0, "min": float("inf"),
                                 "max": float("-inf")}[red], device=dev)
        before = segment_reduce.launches
        hier, st = sess.map_reduce(v, dense, red, t, engine="pallas", return_stats=True)
        assert segment_reduce.launches - before == 8 and "hier" in st.collective
        flat = sess.map_reduce(v, dense, red, t, engine="pallas", hierarchical=False)
        assert torch.equal(hier, flat)
        want = getattr(torch.from_numpy(rows).reshape(-1, 16, 4), "amin" if red == "min"
                       else "amax" if red == "max" else "sum")(0)
        assert torch.equal(hier.cpu(), want)
    words = g.randint(0, 500, 1 << 14).astype(np.int32)
    hm = sess.make_dist_hashmap(1024, (), torch.int32, "sum")
    before = HK.hash_aggregate.launches
    hm, st = sess.map_reduce(sess.distribute(words), lambda i, w, emit: emit(w, 1), "sum",
                             hm, engine="pallas", key_range=500, return_stats=True)
    assert HK.hash_aggregate.launches - before == 16  # combine and merge, a shard each
    assert {int(k): int(c) for k, c in hm.to_dict().items()} == dict(
        zip(*np.unique(words, return_counts=True)))
    st = st.finalize()
    assert abs(st.inter_bytes - 0.5 * st.shuffle_payload_bytes) <= 1


def test_multinode_program_captures_degrades_and_recaptures(dev, ledger):
    """The degraded-program case on a (2x4) mesh: the program's dense node
    is hierarchical, a kernel fault at a replay's dispatch degrades it, the
    program captures again into the same carry and buffers, and the run
    equals one that was eager from the start, exactly."""
    from repro_torch.launch.mesh import make_node_data_mesh

    mesh = make_node_data_mesh(2, n_shards=8, device=dev)
    x = np.arange(1 << 16, dtype=np.float32) % 509

    def run(engine_fault):
        sess = BlazeSession(mesh=mesh)
        hm = sess.make_dist_hashmap(256, (), torch.float32, "sum")
        prog = sess.program(_k1_k2_step(sess, sess.distribute(x), hm, dev))
        state = prog({"acc": torch.zeros(8, device=dev)}, 1)
        assert prog.plan.n_nodes == 2
        assert [n.hier for n in prog.plan.mapreduce_nodes()] == [False, True]
        carry = prog._carry[prog._last_sig]
        bufs = [*carry.state_in] + [a for t in carry.tables.values()
                                    for a in (t.keys, t.vals, t.overflow)]
        ptrs = [b.data_ptr() for b in bufs]
        if engine_fault:
            ledger.configure("kernel.segment", at=1)
        for _ in range(2):
            state = sess.supervised(lambda s=state: prog(s, 1), program=prog)
        assert [b.data_ptr() for b in bufs] == ptrs
        return sess, prog, state, prog.hash_result(hm)

    sess, prog, state, hm = run(True)
    assert prog.stats.degradations == 1 and prog.stats.captures == 2
    assert sess.stats.degraded_nodes == 1
    assert all(n.engine == "eager" for n in prog.plan.mapreduce_nodes())
    assert prog.plan.mapreduce_nodes()[1].hier  # still hierarchical, now eager
    snap = ledger.snapshot()
    assert snap["balanced"] and snap["dispositions"]["degraded"] == 1
    ledger.reset(env=False)
    _, _, want, want_hm = run(False)
    assert torch.equal(state["acc"], want["acc"])
    assert hm.to_dict() == want_hm.to_dict()


def test_nccl_program_of_one_rank_captures_and_matches_in_process(dev, tmp_path):
    """An NCCL group of world size 1 in this process: the (1x8) mesh that
    carries it runs a program with a K2 node (its all-to-all) and a K1 node
    (its all-gathered reduce); the program captures the collectives inside
    its graph under sync-debug "error", replays, and equals the in-process
    (1x8) program: the dense sums bit for bit (integer-valued rows), the
    hash table as a dict."""
    import torch.distributed as dist

    from repro_torch.core import containers as C
    from repro_torch.launch.mesh import make_node_data_mesh

    x = np.arange(1 << 16, dtype=np.float32) % 509

    def run(mesh):
        sess = BlazeSession(mesh=mesh)
        hm = sess.make_dist_hashmap(256, (), torch.float32, "sum")
        prog = sess.program(_k1_k2_step(sess, sess.distribute(x), hm, dev))
        state = prog({"acc": torch.zeros(8, device=dev)}, 1)
        state = prog(state, 2)
        return prog, state, prog.hash_result(hm).to_dict()

    _, want, want_hm = run(C.data_mesh(8, dev))
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            world_size=1, rank=0)
    try:
        mesh = make_node_data_mesh(n_shards=8, device=dev)
        assert mesh.process and (mesh.n_nodes, mesh.n_local, mesh.n_ranks) == (1, 8, 1)
        prog, got, hm = run(mesh)
    finally:
        dist.destroy_process_group()
    assert (prog.stats.captures, prog.stats.replays) == (2, 2)
    assert prog.stats.replay_launches.get("segment_reduce", 0) > 0
    assert prog.stats.replay_launches.get("hash_aggregate", 0) > 0
    assert torch.equal(got["acc"], want["acc"])
    assert {k: float(v) for k, v in hm.items()} == {k: float(v) for k, v in want_hm.items()}


# -- gradients through the kernels (the training slice) ----------------------


def _grad_case(op, dev):
    """Small inputs that require grad, the kernel route (``ops`` with
    ``impl="pallas"``), the plain route and the kernel's wrapper."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv6_scan as RS

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype).requires_grad_()

    if op == "attention":
        q, k, v = randn(2, 64, 4, 16).transpose(1, 2), randn(2, 64, 2, 16), randn(2, 64, 2, 16)
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        return ((q, k, v), lambda *t: ops.attention(*t, impl="pallas"),
                lambda *t: attention_ref(*t), FA.flash_attention)
    if op == "ssd":
        x, bm, cm = randn(2, 64, 4, 16), randn(2, 64, 2, 16), randn(2, 64, 2, 16)
        dt = torch.nn.functional.softplus(randn(2, 64, 4, dtype=torch.float32)).detach()
        a = -torch.arange(1.0, 5.0, device=dev)
        inputs = (x, dt.requires_grad_(), a.requires_grad_(), bm, cm)
        return (inputs, lambda *t: ops.ssd(*t, impl="pallas"),
                lambda *t: ssd_scan_plain(*t), SS.ssd_scan)
    r, k, v = randn(2, 64, 4, 16), randn(2, 64, 4, 16), randn(2, 64, 4, 16)
    w = torch.exp(-torch.exp(randn(2, 64, 4, 16, dtype=torch.float32).detach() - 2.0))
    u = randn(4, 16, dtype=torch.float32)
    return ((r, k, v, w.requires_grad_(), u), lambda *t: ops.rwkv6(*t, impl="pallas"),
            lambda *t: rwkv6_scan_plain(*t), RS.rwkv6_scan)


@pytest.mark.parametrize("op", ["attention", "ssd", "rwkv6"])
def test_kernel_route_carries_the_plain_versions_gradient(dev, op):
    """The kernel's output carries the autograd helper's ``grad_fn``, the
    launch is counted, and the gradients are the plain route's: the backward
    recomputes the plain version on the same inputs, so they agree within
    ``2^-20`` of each gradient's largest magnitude (the order of a library
    call's f32 sums aside, bit for bit)."""
    inputs, kernel_route, plain_route, wrapper = _grad_case(op, dev)
    before = wrapper.launches
    out = kernel_route(*inputs)
    y = out[0] if isinstance(out, tuple) else out
    assert wrapper.launches == before + 1
    assert "_KernelGrad" in type(y.grad_fn).__name__
    plain = plain_route(*inputs)
    yp = plain[0] if isinstance(plain, tuple) else plain
    up = torch.randn(yp.shape, device=dev).to(yp.dtype)
    wants = [t for t in inputs if t.requires_grad]
    for a, b in zip(torch.autograd.grad(y, wants, up), torch.autograd.grad(yp, wants, up)):
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).abs().max()) <= 2.0 ** -20 * float(
            b.float().abs().max())
    with torch.no_grad():  # the serving path: the kernel alone, no graph
        out = kernel_route(*inputs)
    assert all(o.grad_fn is None for o in (out if isinstance(out, tuple) else (out,)))
    assert wrapper.launches == before + 2


@pytest.mark.parametrize("op", ["ssd", "rwkv6"])
def test_differentiated_cache_write_raises_on_the_card(dev, op):
    inputs, _, _, _ = _grad_case(op, dev)
    fn = ops.ssd if op == "ssd" else ops.rwkv6
    b, _, h = inputs[0].shape[:3]
    state = torch.zeros((b, h, 16, 16), device=dev)  # [B, H, P, N] / [B, H, K, V]
    with pytest.raises(ValueError, match="out_state"):
        fn(*inputs, init_state=state, out_state=state, impl="pallas")


def test_train_steps_on_the_card_run_k4_forward_and_remat(dev, tmp_path):
    """Reduced qwen3-0.6b in bf16 through ``train``: K4 on every attention
    call, twice a layer a micro-batch (forward, then the remat recompute),
    finite losses that fall."""
    import dataclasses

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import train

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.runtime import train_loop as T

    cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    FA.flash_attention.launches = 0
    T.stats.reset()
    res = train(cfg, steps=6, batch=4, seq_len=64, grad_accum=2,
                pipeline=TokenPipeline(cfg, batch=4, seq_len=64),
                ckpt_dir=str(tmp_path), optimizer=AdamW(lr=1e-2), device=dev)
    # train(jit=True) captures the step: the wrappers count the warm-up's
    # calls and the capture's (which launch nothing), the graph's stats the
    # 5 replays'; the kernels that ran are the warm-up's and the replays'
    step = 2 * 2 * 2
    assert (res.captures, res.replays) == (1, 5) == (T.stats.captures, T.stats.replays)
    assert FA.flash_attention.launches == 2 * step
    assert T.stats.capture_launches["flash_attention"] == step
    assert (FA.flash_attention.launches - T.stats.capture_launches["flash_attention"]
            + T.stats.replay_launches["flash_attention"]) == step * 6
    assert all(np.isfinite(res.losses)) and res.losses[-1] < res.losses[0]
    # the checkpoint after 6 steps (5 of them replays) holds step 6
    params = M.init(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = AdamW(lr=1e-2)
    step_at, tree = CheckpointManager(str(tmp_path)).restore_latest(
        T._ckpt_tree(params, opt.init(params)))
    assert step_at == 6 and int(tree["opt"]["step"]) == 6


def _train_run(cfg, dev, batches, accum, capture):
    """Steps of ``TrainGraph`` from the seeded state over ``batches``:
    (losses, every distinct parameter, m, v and step, the graph, the
    wrappers' launches over the run)."""
    from repro_torch.core.program import launch_counts
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.runtime import train_loop as T

    opt = AdamW(lr=warmup_cosine(1e-2, 1, len(batches)))
    params = M.init(torch.Generator(device=dev).manual_seed(0), cfg)
    state = opt.init(params)
    step_fn = T.make_train_step(cfg, opt, grad_accum=accum, device=dev)
    before = launch_counts()
    graph = T.TrainGraph(step_fn, params, state, batches[0], capture=capture,
                         name=cfg.name)
    losses = [graph.step(b).clone() for b in batches]
    torch.cuda.synchronize(dev)
    after = launch_counts()
    bits = (M.distinct_leaves(params) + M.distinct_leaves(state["m"])
            + M.distinct_leaves(state["v"]) + [state["step"]])
    return (torch.stack(losses), bits, graph,
            {k: after[k] - before[k] for k in after if after[k] != before[k]})


@torch.no_grad()
def _max_diff(a, b) -> float:
    (la, ba), (lb, bb) = a, b
    return max([float((la - lb).abs().max())]
               + [float((x.float() - y.float()).abs().max()) for x, y in zip(ba, bb)])


@pytest.mark.parametrize("arch,accum", [("qwen3-0.6b", 2), ("zamba2-7b", 1),
                                        ("rwkv6-1.6b", 1), ("mixtral-8x22b", 1),
                                        ("gemma2-9b", 2)])
def test_train_graph_replays_match_the_eager_twin(dev, arch, accum):
    """Reduced models in bf16, 4 steps captured against the eager twin from
    the same state and batches: the losses, parameters, moments and step
    equal the twin's bit for bit, or lie no further from them than a second
    eager run does (an atomic sum in a backward may differ between runs);
    the graph's replays counted, and K4/K5/K6 counted through them: the
    warm-up's and the replays' launches are the eager run's."""
    from repro_torch.runtime import train_loop as T

    cfg = _bf16_reduced(arch)
    rng = np.random.RandomState(0)
    batches = [{k: torch.from_numpy(rng.randint(0, cfg.vocab, (4, 64)).astype(np.int32))
                .to(dev) for k in ("inputs", "labels")} for _ in range(4)]
    T.stats.reset()
    eager = _train_run(cfg, dev, batches, accum, capture=False)
    again = _train_run(cfg, dev, batches, accum, capture=False)
    got = _train_run(cfg, dev, batches, accum, capture=True)
    spread = _max_diff(eager[:2], again[:2])
    err = _max_diff(got[:2], eager[:2])
    assert err <= spread, (err, spread)
    assert bool(torch.isfinite(got[0]).all()) and int(got[1][-1]) == 4
    graph, wrappers = got[2], got[3]
    per_step = {k: n // 4 for k, n in eager[3].items()}
    assert all(n * 4 == eager[3][k] for k, n in per_step.items())
    kinds = M.layer_kinds(cfg)
    for kernel, present in (("flash_attention", any(k in M._ATTN_KINDS for k in kinds)),
                            ("ssd_scan", MAMBA2 in kinds), ("rwkv6_scan", RWKV6 in kinds)):
        assert (per_step.get(kernel, 0) > 0) == present, (kernel, per_step)
    assert graph.replays == 3 == T.stats.replays and T.stats.captures == 1
    assert graph.captured_launches == per_step == T.stats.capture_launches
    assert wrappers == {k: 2 * n for k, n in per_step.items()}  # warm-up + capture
    assert graph.replay_launches == {k: 3 * n for k, n in per_step.items()}
    ran = {k: wrappers[k] - graph.captured_launches[k] + graph.replay_launches[k]
           for k in wrappers}
    assert ran == eager[3]


def test_train_capture_that_syncs_raises_naming_the_arch(dev, monkeypatch, tmp_path):
    """A step that reads a value on the host cannot be captured: the capture
    raises naming the model and the step, leaves no graph, and ``train``
    does not fall back to the eager step."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import train_loop as T

    cfg = _bf16_reduced("qwen3-0.6b")
    loss_fn = M.loss_fn

    def syncing(*a, **kw):
        loss = loss_fn(*a, **kw)
        if loss.item() > -1.0:  # a host sync
            return loss
        return loss * 0

    monkeypatch.setattr(M, "loss_fn", syncing)
    opt = AdamW(lr=1e-3)
    params = M.init(torch.Generator(device=dev).manual_seed(0), cfg)
    state = opt.init(params)
    batch = TokenPipeline(cfg, batch=2, seq_len=32).device_batch(0, dev)
    graph = T.TrainGraph(T.make_train_step(cfg, opt, device=dev), params, state, batch,
                         name=cfg.name, start=3)
    with pytest.raises(RuntimeError, match=r"capture of qwen3-0\.6b-reduced's training "
                                           r"step at step 4"):
        graph.step(batch)
    assert graph.graph is None and graph.replays == 0
    assert torch.cuda.get_sync_debug_mode() == 0
    with pytest.raises(RuntimeError, match="capture of qwen3-0.6b-reduced's training step"):
        T.train(cfg, steps=3, batch=2, seq_len=32, pipeline=TokenPipeline(cfg, 2, 32),
                ckpt_dir=str(tmp_path), optimizer=opt, device=dev)


def test_train_restart_captures_again(dev, tmp_path):
    """A crash at step 3 (a checkpoint every 2) resumes from step 2 through
    a new capture: 2 captures, and every step but each start's first a
    replay; step 2's loss, taken by a replay before the crash and by the
    warm-up after it from the step-2 checkpoint, the same bits."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import train

    cfg = _bf16_reduced("qwen3-0.6b")
    kw = dict(steps=6, batch=2, seq_len=32, pipeline=TokenPipeline(cfg, 2, 32),
              ckpt_every=2, optimizer=AdamW(lr=1e-3), device=dev)
    res = train(cfg, ckpt_dir=str(tmp_path / "crash"), crash_at_step=3, **kw)
    # start 1: step 0 warm-up, 1-2 replays, crash before 3; start 2: step 2
    # warm-up (from the step-2 checkpoint), 3-5 replays
    assert (res.restarts, res.final_step, res.steps_run) == (1, 6, 3 + 4)
    assert (res.captures, res.replays) == (2, 2 + 3)
    assert res.losses[3] == res.losses[2]
    eager = train(cfg, ckpt_dir=str(tmp_path / "eager"), jit=False, **kw)
    assert (eager.captures, eager.replays, eager.steps_run) == (0, 0, 6)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "grok-1-314b", "qwen2-vl-2b",
                                  "musicgen-medium"])
def test_moe_and_embedding_archs_run_k4_on_the_card(dev, arch):
    """Reduced MoE, M-RoPE and embedding-fed models in f32 on the card: a
    30-token prefill and 4 decode steps in a 40-row cache (mixtral's window
    of 16 then reads its view), K4 (f32 form) on every attention call, the
    logits within ``1e-3`` of the plain path's (K4 is within ``3e-5`` of
    ``attention_ref`` an output; the reduced routers' top-2 gaps lie far
    above that, so both paths route alike)."""
    from repro_torch.kernels import flash_attention as FA

    cfg = get_arch(arch).reduced()
    g = torch.Generator(device=dev).manual_seed(0)
    params = M.init(g, cfg)
    if cfg.embed_inputs:
        x = torch.randint(0, cfg.vocab, (2, 34), generator=g, device=dev)
    else:
        x = torch.randn((2, 34, cfg.d_model), generator=g, device=dev)
    out = {}
    for impl in ("auto", "ref"):
        caches = M.make_caches(cfg, 2, 40, dev)
        FA.flash_attention.launches = 0
        steps = [M.prefill(params, cfg, x[:, :30], caches, attn_impl=impl)[0]]
        for i in range(30, 34):
            steps.append(M.decode_step(params, cfg, x[:, i:i + 1], caches, i,
                                       attn_impl=impl)[0])
        assert FA.flash_attention.launches == (cfg.n_layers * 5 if impl == "auto" else 0)
        out[impl] = torch.stack(steps, 1)
    assert bool(torch.isfinite(out["auto"]).all())
    assert float((out["auto"] - out["ref"]).abs().max()) <= 1e-3
