"""The port's fused k-means assignment (K3) and its kernel-ops entry points
against the JAX package's, on the same numpy inputs.

JAX's Pallas kernel runs in interpret mode on the CPU, as its own tests run
it; the port's wrappers take their plain PyTorch versions on CPU tensors
(``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the CUDA kernel
against those on the card).

Tolerances: an assignment must match exactly unless the point is a near tie
(``near_ties``: the best and second-best ``d²`` lie within the f32 rounding
of either, where two orders of the products may disagree); the statistics
within ``atol=1e-3``, as the JAX package's own kernel test, and on points
whose assignment flipped they are held against float64 sums under the
port's own assignment.

``kmeans_assign_tiled`` is the CUDA kernel's stream form (K <= 8, D <= 4) in
f32 torch: its head, tiles and tail, each thread's running sums in order,
the warp tree and the warps' and CTAs' merges in order.  It is held against
JAX's kernel in the same way, its sums against float64 sums within the
smoke's tolerance ``1e-5·|sum| + max(1e-5, m·2^-24)·Σ|x|``, where ``m`` is
the longest chain of f32 additions into the key, which must equal
``chip_smoke.stream_additions``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.kernels.kmeans_assign import kmeans_assign as jkmeans_assign
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels.kmeans_assign import (
    STREAM_WARPS,
    TILE,
    kmeans_assign,
    kmeans_assign_plain,
    near_ties,
    stream_layout,
)

CASES = [(1000, 3, 5, 256), (777, 8, 13, 128), (64, 2, 2, 64)]


def _data(n, d, k, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32), rng.randn(k, d).astype(np.float32)


def _assert_assign(got, want, ties):
    got, want = np.asarray(got), np.asarray(want)
    decided = ~ties.numpy()
    np.testing.assert_array_equal(got[decided], want[decided])


def _assert_stats(stats, assign, want_stats, want_assign, pts):
    """Stats within 1e-3 of ``want_stats``; where a near tie flipped an
    assignment, of float64 sums under the port's own assignment instead."""
    assign = np.asarray(assign)
    if np.array_equal(assign, np.asarray(want_assign)):
        want = np.asarray(want_stats)
    else:
        x1 = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
        want = np.zeros(np.shape(want_stats))
        np.add.at(want, assign, x1.astype(np.float64))
    np.testing.assert_allclose(np.asarray(stats), want, atol=1e-3)


@pytest.mark.parametrize("n,d,k,bn", CASES)
def test_kmeans_assign_matches_jax_kernel(n, d, k, bn):
    pts, ctr = _data(n, d, k, seed=n + d)
    ja, js = jkmeans_assign(jnp.asarray(pts), jnp.asarray(ctr), block_n=bn,
                            interpret=True)
    tp, tc = torch.from_numpy(pts), torch.from_numpy(ctr)
    ties = near_ties(tp, tc)
    for got_a, got_s in (kmeans_assign_plain(tp, tc),
                         kmeans_assign(tp, tc, block_n=bn),
                         ops.kmeans_assign(tp, tc, impl="pallas", block_n=bn)):
        assert got_a.dtype == torch.int32 and got_s.dtype == torch.float32
        assert got_s.shape == (k, d + 1)
        _assert_assign(got_a, ja, ties)
        _assert_stats(got_s, got_a, js, ja, pts)


@pytest.mark.parametrize("n,d,k,bn", CASES)
def test_kmeans_assign_matches_ref(n, d, k, bn):
    """The kernel's wrapper against both packages' full-formula oracles,
    and ``impl="auto"`` on a CPU tensor is the port's oracle."""
    pts, ctr = _data(n, d, k, seed=3 * n)
    tp, tc = torch.from_numpy(pts), torch.from_numpy(ctr)
    ja, js = JR.kmeans_assign_ref(jnp.asarray(pts), jnp.asarray(ctr))
    ra, rs = R.kmeans_assign_ref(tp, tc)
    aa, as_ = ops.kmeans_assign(tp, tc, impl="auto")
    assert torch.equal(aa, ra) and torch.equal(as_, rs)
    np.testing.assert_array_equal(ra.numpy(), np.asarray(ja))
    np.testing.assert_allclose(rs.numpy(), np.asarray(js), atol=1e-3)
    ka, ks = kmeans_assign(tp, tc, block_n=bn)
    _assert_assign(ka, ra, near_ties(tp, tc, with_norm_x=True))
    _assert_stats(ks, ka, rs, ra, pts)


@pytest.mark.parametrize("centers,first", [
    ([[1.0, 0.0], [1.0, 0.0], [-1.0, 0.0]], 0),
    ([[-1.0, 0.0], [1.0, 0.0], [1.0, 0.0]], 1),
    ([[0.0, 2.0], [0.5, -1.0], [0.5, -1.0], [0.5, -1.0]], 1),
])
def test_kmeans_assign_ties_pick_the_first_index(centers, first):
    """Two equal centres give equal d² bit for bit: both packages pick the
    lower index, as ``jnp.argmin`` does."""
    ctr = np.asarray(centers, np.float32)
    rng = np.random.RandomState(5)
    pts = (ctr[first] + 0.1 * rng.randn(40, 2)).astype(np.float32)
    ja, _ = jkmeans_assign(jnp.asarray(pts), jnp.asarray(ctr), block_n=16,
                           interpret=True)
    ta, ts = kmeans_assign(torch.from_numpy(pts), torch.from_numpy(ctr))
    np.testing.assert_array_equal(np.asarray(ja), np.full(40, first))
    np.testing.assert_array_equal(ta.numpy(), np.full(40, first))
    assert ts[first, -1] == 40 and float(ts[:, -1].sum()) == 40


def test_kmeans_assign_empty_and_refused_shapes():
    a, s = kmeans_assign(torch.zeros((0, 3)), torch.ones((4, 3)))
    assert a.shape == (0,) and a.dtype == torch.int32
    assert torch.equal(s, torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="K > 0"):
        kmeans_assign(torch.zeros((5, 3)), torch.zeros((0, 3)))
    with pytest.raises(ValueError, match=r"\[N, D\]"):
        kmeans_assign(torch.zeros((5, 3)), torch.zeros((2, 4)))


def test_near_ties_marks_only_close_calls():
    ctr = torch.tensor([[1.0, 0.0], [-1.0, 0.0]])
    pts = torch.tensor([[0.0, 3.0], [1e-9, 1.0], [0.5, 0.0], [-2.0, 0.0]])
    assert near_ties(pts, ctr).tolist() == [True, True, False, False]
    assert not near_ties(pts, ctr[:1]).any()


@pytest.mark.parametrize("impl", ("auto", "pallas", "ref"))
def test_segment_reduce_entry_point_matches_jax(impl):
    rng = np.random.RandomState(11)
    ids = rng.randint(-2, 19, 300).astype(np.int32)
    vals = rng.randint(-8, 9, (300, 3)).astype(np.float32)
    want = jops.segment_reduce(jnp.asarray(ids), jnp.asarray(vals), 16,
                               impl="ref" if impl == "auto" else impl)
    got = ops.segment_reduce(torch.from_numpy(ids), torch.from_numpy(vals), 16,
                             impl=impl)
    assert got.shape == (16, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_entry_points_refuse_unknown_impls():
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.kmeans_assign(x, x, impl="chunked")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.segment_reduce(torch.zeros(4, dtype=torch.int32), x, 2, impl="triton")


def kmeans_assign_tiled(points, centers, *, offset=0, blocks=3):
    """The stream form's arithmetic in f32 torch, for points that start
    ``offset`` floats past 16 bytes, over ``blocks`` CTAs of
    ``32·STREAM_WARPS`` consumer threads: tile ``j`` (``TILE`` points after
    the head of ``stream_layout``) goes to CTA ``j mod blocks``, its points
    ``4t..4t+3`` in that order to thread ``t``; then the head and the tail,
    in order and round robin, to the threads of CTA ``tiles mod blocks``.
    Each thread adds ``[x | 1]`` into its own ``[K, D+1]`` running sums;
    lane 0 of each warp sums its warp's lanes in a 5-level tree (``v[i] +=
    v[i + 16]``, then 8, 4, 2, 1), the CTA adds its warps in order and the
    output its CTAs in order.  Returns ``(assign [N] int32, stats [K, D+1]
    f32, chain [K])``, ``chain`` the additions on each key's longest chain:
    the most points one thread added into it, plus each merge's
    additions."""
    n, d = points.shape
    k = centers.shape[0]
    head, _, tiles = stream_layout(n, d, offset)
    lanes = 32 * STREAM_WARPS
    cn = (centers * centers).sum(1)
    acc = torch.zeros((blocks * lanes, k, d + 1), dtype=torch.float32)
    adds = torch.zeros((blocks * lanes, k), dtype=torch.int64)
    assign = torch.empty(n, dtype=torch.int32)

    def fold(threads, idx):  # one point for each of these distinct threads
        x = points[idx]
        a = torch.argmin(cn[None, :] - 2.0 * (x @ centers.T), dim=1)
        assign[idx] = a.to(torch.int32)
        acc[threads, a] += torch.cat([x, torch.ones_like(x[:, :1])], 1)
        adds[threads, a] += 1

    t = torch.arange(lanes)
    for first in range(0, tiles, blocks):  # each CTA's next tile, all CTAs at once
        js = torch.arange(first, min(first + blocks, tiles))
        threads = ((js % blocks)[:, None] * lanes + t).reshape(-1)
        for p in range(4):
            fold(threads, (head + js[:, None] * TILE + 4 * t + p).reshape(-1))
    extra = n - tiles * TILE
    for q0 in range(0, extra, lanes):
        q = torch.arange(q0, min(q0 + lanes, extra))
        fold(tiles % blocks * lanes + q % lanes, torch.where(q < head, q, q + tiles * TILE))
    v = acc.view(blocks, STREAM_WARPS, 32, k, d + 1)
    for half in (16, 8, 4, 2, 1):
        v = v[:, :, :half] + v[:, :, half:2 * half]
    cta = v[:, 0, 0]
    for w in range(1, STREAM_WARPS):
        cta = cta + v[:, w, 0]
    stats = cta[0]
    for b in range(1, blocks):
        stats = stats + cta[b]
    chain = adds.amax(0) + 5 + (STREAM_WARPS - 1) + (blocks - 1)
    return assign, stats, chain


TILED_CASES = [  # (n, d, k, start in points, offset of the buffer in floats)
    *[(n, d, k, 0, 0) for n, d, k, _ in CASES],
    (5000, 1, 8, 0, 0), (4100, 4, 1, 0, 0), (3001, 4, 8, 0, 0), (2500, 1, 1, 0, 0),
    (100, 4, 8, 0, 0),  # under one tile: every point read with plain loads
    (5003, 3, 5, 1, 0), (5003, 3, 5, 2, 0), (5003, 3, 5, 3, 0),  # a head
    (4099, 2, 3, 1, 1), (4099, 4, 8, 0, 1), (4099, 4, 8, 0, 2), (4099, 4, 8, 0, 3),  # shifted
]


@pytest.mark.parametrize("n,d,k,start,skew", TILED_CASES)
def test_kmeans_assign_tiled_matches_jax_kernel(n, d, k, start, skew):
    """The design's arithmetic against JAX's kernel (interpret mode) on a
    view that starts ``start`` points into a buffer that starts ``skew``
    floats past 16 bytes; its sums within the smoke's tolerance of float64
    sums, a zero result outside it, and a second call equal bit for bit."""
    import chip_smoke

    buf, ctr = _data(n + start + 1, d, k, seed=7 * n + d + start + skew)
    pts = buf[start:start + n]
    offset = skew + start * d
    ja, js = jkmeans_assign(jnp.asarray(pts), jnp.asarray(ctr), block_n=1024,
                            interpret=True)
    tp, tc = torch.from_numpy(pts), torch.from_numpy(ctr)
    a, s, chain = kmeans_assign_tiled(tp, tc, offset=offset)
    _assert_assign(a, ja, near_ties(tp, tc))
    _assert_stats(s, a, js, ja, pts)
    x1 = torch.cat([tp, torch.ones((n, 1))], 1).double()
    want = torch.zeros((k, d + 1), dtype=torch.float64).index_add_(0, a.long(), x1)
    mag = torch.zeros_like(want).index_add_(0, a.long(), x1.abs())
    tol = 1e-5 * want.abs() + torch.clamp(chain[:, None] * 2.0 ** -24, min=1e-5) * mag
    assert bool(((s.double() - want).abs() <= tol).all())
    assert not bool((want.abs() <= tol).all())  # a zero result fails
    assert torch.equal(chain[:, None], chip_smoke.stream_additions(a, n, d, k, offset, 3))
    a2, s2, _ = kmeans_assign_tiled(tp, tc, offset=offset)
    assert torch.equal(a, a2) and torch.equal(s, s2)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_stream_layout_copies_aligned_tiles_inside_the_points(d):
    """For every start, the tiles' copies begin on 16 bytes, stay inside the
    points, and the head, tiles and tail cover every point once."""
    lanes = 32 * STREAM_WARPS
    for offset in range(4):
        for n in (0, 3, TILE - 1, TILE, TILE + 1, TILE + 2, 3 * TILE + 5, 7 * TILE):
            head, shift, tiles = stream_layout(n, d, offset)
            assert 0 <= head <= 3 and 0 <= shift <= 3 and tiles * TILE <= n - head
            if tiles:
                first = offset + head * d - shift  # floats past 16 bytes
                assert first % 4 == 0 and first >= offset
                assert first + tiles * TILE * d + (4 if shift else 0) <= offset + n * d
            assert n - tiles * TILE < TILE + (TILE if shift else 0) + 4
        from repro_torch.kernels.kmeans_assign import stream_threads

        thr = stream_threads(5 * TILE + 7, d, offset, 3)
        assert int(thr.max()) < 3 * lanes
        assert int(torch.bincount(thr).max()) <= 4 * 2 + 1  # 5 tiles over 3 CTAs
