"""Out-of-core chunked datasets in the port, mirroring
``tests/test_streaming.py``: a dataset larger than one resident block,
streamed a block at a time through one stage (per op) or one program
(``run_stream``), gives the in-memory result bit for bit, for ``map_reduce``
(dense and hash targets), ``run_stream`` with and without prefetch, and the
wordcount, k-means and PageRank drivers; each driver is also held against
the reference's ``mode="stream"`` on the same chunked input.

Tolerances: exact everywhere (integer counts, integer-valued f32 points and
sums that stay exact in f32, PageRank on a chain whose pages each take one
in-link), except k-means' inertia (``rtol=1e-5``: its ``min d²`` sums
reassociate across blocks) and PageRank against the per-op run and the
float64 reference (``atol`` 1e-7 and 1e-5, as in the reference's test) and
against the reference's own stream (``atol=1e-7``: XLA rounds Eq. 1's
update in another order; the port's stream equals its in-memory program bit
for bit).
"""
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlazeSession as JaxSession
from repro.core.algorithms.kmeans import kmeans as jkmeans
from repro.core.algorithms.pagerank import pagerank as jpagerank
from repro.core.algorithms.pagerank import pagerank_reference
from repro.core.algorithms.wordcount import counts_dict as jcounts_dict
from repro.core.algorithms.wordcount import wordcount as jwordcount
from repro_torch.core import BlazeSession, ChunkedDistVector
from repro_torch.core.algorithms import counts_dict, kmeans, pagerank, wordcount


def _cpu():
    return BlazeSession(device="cpu")


def _sq_mapper(i, x, emit):
    emit(i % 7, x * x)


def _mod_mapper(i, x, emit):
    emit(x.to(torch.int32) % 11, 1)


# -- the container --------------------------------------------------------------


def test_chunked_roundtrip_and_padding():
    sess = _cpu()
    x = np.arange(1003, dtype=np.float32)  # not a multiple of the block
    cv = sess.chunked(x, block_rows=256)
    assert isinstance(cv, ChunkedDistVector)
    assert cv.n == 1003 and cv.n_blocks == 4
    np.testing.assert_array_equal(cv.collect(), x)
    jcv = JaxSession().chunked(x, block_rows=256)
    assert (cv.n_blocks, cv.block_rows, cv.block_nbytes) == (
        jcv.n_blocks, jcv.block_rows, jcv.block_nbytes)
    # the last block is padded to the block shape but reports its true rows
    assert cv.block_true_rows(3) == 1003 - 3 * 256
    assert cv.block_host(3).shape[0] == 256
    np.testing.assert_array_equal(cv.block_host(3), jcv.block_host(3))
    bv = cv.block_view(2)
    assert int(bv.base) == 512 and bv.n == 1003 and bv.data.shape == (256,)
    assert not cv.stats()["pinned"]  # pinned only on a CUDA machine


def test_chunked_compress_and_spill_lru():
    sess = _cpu()
    x = np.arange(5 * 64, dtype=np.float32)
    with tempfile.TemporaryDirectory() as d:
        cv = sess.chunked(x, block_rows=64, compress=True, spill_dir=d, max_resident=2)
        assert cv.n_blocks == 5
        np.testing.assert_array_equal(cv.collect(), x)
        st = cv.stats()
        assert st["spill_bytes"] > 0  # the LRU evicted past max_resident=2
        assert st["resident_blocks"] <= 2 and st["compressed_bytes"] > 0
        # spilled blocks reload (bit for bit), as arrays and as tensors
        np.testing.assert_array_equal(cv.collect(), x)
        assert cv.stats()["loads_from_disk"] > 0
        for b in range(cv.n_blocks):
            np.testing.assert_array_equal(cv.block_tensor(b).numpy(), cv.block_host(b))
    with tempfile.TemporaryDirectory() as d:  # raw blocks spill too
        cv = sess.chunked(x, block_rows=64, spill_dir=d, max_resident=1)
        np.testing.assert_array_equal(cv.collect(), x)
        assert cv.stats()["spill_bytes"] == 5 * 64 * 4  # every block, once


def test_chunked_rejects_bad_block_rows():
    with pytest.raises(ValueError):
        _cpu().chunked(np.arange(8, dtype=np.float32), block_rows=0)


# -- map_reduce over chunked sources ----------------------------------------------


def test_chunked_map_reduce_dense_bit_equal_one_compile():
    sess = _cpu()
    # integer-valued with bounded sums: every partial is exact in f32
    x = (np.arange(1000) % 57).astype(np.float32)
    ref = sess.map_reduce(sess.distribute(x), _sq_mapper, "sum", torch.zeros(7))
    cv = sess.chunked(x, block_rows=128)  # 8 blocks
    c0 = sess.stats.compiles
    got, stats = sess.map_reduce(cv, _sq_mapper, "sum", torch.zeros(7),
                                 return_stats=True)
    assert torch.equal(ref, got)
    assert sess.stats.compiles - c0 == 1  # one stage serves all 8 blocks
    fs = stats.finalize()
    assert fs.dispatches == cv.n_blocks and fs.pairs_emitted == 1000
    js = JaxSession()
    jgot = js.map_reduce(js.chunked(x, block_rows=128), _sq_mapper, "sum",
                         jnp.zeros((7,), jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


@pytest.mark.parametrize("engine", ["eager", "pallas"])
def test_chunked_map_reduce_hash_target_equal(engine):
    sess = _cpu()
    x = np.arange(500, dtype=np.float32)
    hm_ref = sess.make_dist_hashmap(256, (), torch.int32, "sum")
    hm_ref = sess.map_reduce(sess.distribute(x), _mod_mapper, "sum", hm_ref)
    cv = sess.chunked(x, block_rows=64)
    hm = sess.make_dist_hashmap(256, (), torch.int32, "sum")
    hm = sess.map_reduce(cv, _mod_mapper, "sum", hm, key_range=11, engine=engine)
    assert hm.to_dict() == hm_ref.to_dict()


# -- programs: run_stream -----------------------------------------------------------


def _stream_sum_program(sess, cv, n_blocks):
    def step(ctx, s):
        part = ctx.map_reduce(cv, _sq_mapper, "sum", torch.zeros(7))
        acc = s["acc"] + part
        last = s["blk"] == n_blocks - 1
        return {"acc": torch.where(last, torch.zeros_like(s["acc"]), acc),
                "out": torch.where(last, acc, s["out"]),
                "blk": torch.where(last, torch.zeros_like(s["blk"]), s["blk"] + 1)}

    state = {"acc": torch.zeros(7), "out": torch.zeros(7),
             "blk": torch.zeros((), dtype=torch.int32)}
    return sess.program(step), state


@pytest.mark.parametrize("prefetch", [True, False])
def test_run_stream_bit_equal_and_single_compile(prefetch):
    sess = _cpu()
    x = (np.arange(1003) % 57).astype(np.float32)  # exact f32 sums
    ref = sess.map_reduce(sess.distribute(x), _sq_mapper, "sum", torch.zeros(7))
    cv = sess.chunked(x, block_rows=256)
    prog, state = _stream_sum_program(sess, cv, cv.n_blocks)
    state, info = sess.run_stream(prog, state, prefetch=prefetch)
    assert torch.equal(ref, state["out"])
    assert info.compiles == 1 and info.epochs == 1
    assert info.n_blocks == cv.n_blocks == 4 and info.dispatches == 4
    assert info.prefetch is prefetch
    assert info.bytes_streamed == 4 * cv.block_nbytes
    # a second epoch replays the same program: no new compile
    state, info2 = sess.run_stream(prog, state, prefetch=prefetch)
    assert torch.equal(ref, state["out"]) and info2.compiles == 0


def test_run_stream_block_count_invariant_compiles():
    """One program compile whatever the block count."""
    sess = _cpu()
    x = (np.arange(1024) % 57).astype(np.float32)
    for rows, expect_blocks in ((512, 2), (128, 8)):
        cv = sess.chunked(x, block_rows=rows)
        prog, state = _stream_sum_program(sess, cv, cv.n_blocks)
        c0 = sess.stats.program_compiles
        state, info = sess.run_stream(prog, state)
        assert cv.n_blocks == expect_blocks and info.compiles == 1
        assert sess.stats.program_compiles - c0 == 1


def test_run_stream_spilled_blocks():
    sess = _cpu()
    x = (np.arange(1024) % 57).astype(np.float32)
    ref = sess.map_reduce(sess.distribute(x), _sq_mapper, "sum", torch.zeros(7))
    with tempfile.TemporaryDirectory() as d:
        cv = sess.chunked(x, block_rows=128, compress=True, spill_dir=d, max_resident=2)
        prog, state = _stream_sum_program(sess, cv, cv.n_blocks)
        state, _ = sess.run_stream(prog, state)
        assert torch.equal(ref, state["out"])
        assert cv.stats()["spill_bytes"] > 0


def test_program_call_without_blocks_raises():
    sess = _cpu()
    cv = sess.chunked(np.arange(64, dtype=np.float32), block_rows=32)
    prog, state = _stream_sum_program(sess, cv, cv.n_blocks)
    with pytest.raises(ValueError, match="stream"):
        prog(state, 1)


def test_run_stream_without_chunked_sources_raises():
    sess = _cpu()
    v = sess.distribute(np.arange(64, dtype=np.float32))

    def step(ctx, s):
        return {"out": ctx.map_reduce(v, _sq_mapper, "sum", torch.zeros(7)) + 0.0 * s["out"]}

    with pytest.raises(ValueError, match="no chunked"):
        sess.run_stream(sess.program(step), {"out": torch.zeros(7)})


def test_explain_shows_stream_schedule():
    sess = _cpu()
    cv = sess.chunked(np.arange(1003, dtype=np.float32), block_rows=256)
    prog, state = _stream_sum_program(sess, cv, cv.n_blocks)
    txt = sess.explain(prog, state)
    assert "chunked float32[256] n=1003 blocks=4" in txt
    assert "stream schedule" in txt and "4 block dispatches of 256 rows" in txt


# -- drivers over chunked sources --------------------------------------------------


def _lines(seed=0):
    rng = np.random.RandomState(seed)
    lines = rng.randint(0, 40, size=(600, 8)).astype(np.int32)
    lines[rng.rand(*lines.shape) < 0.25] = -1
    return lines


@pytest.mark.parametrize("engine", ["eager", "pallas"])
def test_wordcount_streaming_bit_equal(engine):
    lines = _lines()
    sess = _cpu()
    ref = counts_dict(wordcount(lines, session=sess, vocab_size=40, engine=engine))
    cv = sess.chunked(lines, block_rows=128)  # 5 blocks
    # program mode: every block of every pass through one program
    res = wordcount(cv, session=sess, vocab_size=40, mode="program", engine=engine)
    assert counts_dict(res.counts) == ref
    assert res.program_compiles == 1 and res.dispatches == cv.n_blocks
    # per op: the session's block loop
    assert counts_dict(wordcount(cv, session=sess, vocab_size=40, engine=engine)) == ref
    js = JaxSession()
    jres = jwordcount(js.chunked(lines, block_rows=128), session=js, vocab_size=40,
                      mode="program", engine=engine)
    assert jcounts_dict(jres.counts) == ref


def test_wordcount_chunked_requires_vocab_size():
    sess = _cpu()
    cv = sess.chunked(np.zeros((8, 4), np.int32), block_rows=4)
    with pytest.raises(ValueError, match="vocab_size"):
        wordcount(cv, session=sess)


@pytest.mark.parametrize("engine", ["eager", "pallas"])
def test_kmeans_streaming_centers_bit_equal(engine):
    rng = np.random.RandomState(1)
    # integer-valued f32 coordinates: per-centre sums are exact, so the
    # reassociation across blocks cannot move the centres
    pts = rng.randint(-20, 20, size=(900, 4)).astype(np.float32)
    init = pts[:5].copy()
    sess = _cpu()
    ref = kmeans(pts, 5, init_centers=init, max_iters=6, session=sess, engine=engine)
    cv = sess.chunked(pts, block_rows=256)  # 4 blocks
    got = kmeans(cv, 5, init_centers=init, max_iters=6, mode="stream", session=sess,
                 engine=engine)
    np.testing.assert_array_equal(ref.centers, got.centers)
    assert ref.iterations == got.iterations and ref.converged == got.converged
    np.testing.assert_allclose(ref.inertia, got.inertia, rtol=1e-5)
    assert got.program_compiles == 1
    js = JaxSession()
    jgot = jkmeans(js.chunked(pts, block_rows=256), 5, init_centers=init, max_iters=6,
                   mode="stream", session=js, engine=engine)
    np.testing.assert_array_equal(np.asarray(jgot.centers), got.centers)
    assert jgot.iterations == got.iterations
    np.testing.assert_allclose(jgot.inertia, got.inertia, rtol=1e-5)


def test_kmeans_chunked_program_mode_rejected():
    sess = _cpu()
    cv = sess.chunked(np.zeros((64, 2), np.float32), block_rows=32)
    with pytest.raises(ValueError, match="stream"):
        kmeans(cv, 2, mode="program", session=sess)


@pytest.mark.parametrize("engine", ["eager", "pallas"])
def test_pagerank_streaming_bit_equal(engine):
    # A chain: each page's incoming sum has one term, so the block
    # accumulation is exact, and the tail page is a sink.
    n = 48
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1).astype(np.int32)
    sess = _cpu()
    ref = pagerank(edges, n, max_iters=15, mode="program", session=sess, engine=engine)
    cv = sess.chunked(edges, block_rows=16)  # 3 blocks
    got = pagerank(cv, n, max_iters=15, mode="stream", session=sess, engine=engine)
    np.testing.assert_array_equal(ref.scores, got.scores)
    assert ref.iterations == got.iterations and ref.converged == got.converged
    assert got.program_compiles == 1
    per_op = pagerank(edges, n, max_iters=15, session=sess, engine=engine)
    np.testing.assert_allclose(got.scores, per_op.scores, atol=1e-7)
    np.testing.assert_allclose(got.scores, pagerank_reference(edges, n, max_iters=15),
                               atol=1e-5)
    js = JaxSession()
    jgot = jpagerank(js.chunked(edges, block_rows=16), n, max_iters=15, mode="stream",
                     session=js, engine=engine)
    # XLA fuses Eq. 1's update into other roundings (5.6e-9 here)
    np.testing.assert_allclose(np.asarray(jgot.scores), got.scores, rtol=0, atol=1e-7)
    assert jgot.iterations == got.iterations


def test_pagerank_streaming_degrees_from_blocks():
    """Out-degrees come from the blocks on the host: the last block's
    padding rows must not add edges."""
    n = 10
    edges = np.asarray([[0, 1], [0, 2], [3, 4]], np.int32)
    sess = _cpu()
    cv = sess.chunked(edges, block_rows=2)  # the last block padded
    got = pagerank(cv, n, max_iters=8, mode="stream", session=sess)
    ref = pagerank(edges, n, max_iters=8, mode="program", session=sess)
    np.testing.assert_array_equal(ref.scores, got.scores)
    js = JaxSession()
    jgot = jpagerank(js.chunked(edges, block_rows=2), n, max_iters=8, mode="stream",
                     session=js)
    np.testing.assert_allclose(np.asarray(jgot.scores), got.scores, rtol=0, atol=1e-7)
