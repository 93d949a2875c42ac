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
    kmeans_assign,
    kmeans_assign_plain,
    near_ties,
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
