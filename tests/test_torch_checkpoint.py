"""The port's checkpoint manager (``repro_torch/checkpoint/manager.py``),
mirroring ``tests/test_checkpoint.py`` (atomic commit, keep-N, async save,
the rename-aside swap under injected crashes, concurrent saves and
restores, ``BlockStore``, elastic restore onto explicit placements).  It
adds resume: ``run_loop`` and ``run_stream`` restarted from a checkpoint in
a new ``Program`` equal the uninterrupted run bit for bit, the k-means one
also the reference's uninterrupted run, and a run checkpointed on a (1x8)
mesh and resumed on a (2x4) one equals the uninterrupted (2x4) run.

Exact comparisons throughout: restored leaves are the saved bytes, and the
resumed runs sum integer-valued points (exact in f32) and count tokens.
"""
import os
import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core import BlazeSession as JaxSession
from repro.core import containers as JC
from repro.core.algorithms.kmeans import _program_step as _jkmeans_step
from repro_torch.checkpoint.manager import BlockStore, CheckpointManager
from repro_torch.core import BlazeSession, data_mesh
from repro_torch.core.algorithms.kmeans import _program_step as _kmeans_step
from repro_torch.core.algorithms.kmeans import _stream_step as _kmeans_stream_step
from repro_torch.core.algorithms.wordcount import _program_step as _wc_step
from repro_torch.launch.mesh import make_node_data_mesh


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": torch.from_numpy(rng.randn(4, 8).astype(np.float32)),
            "b": [torch.from_numpy(rng.randn(3)), torch.tensor(7, dtype=torch.int32)]}


def _assert_tree_equal(x, y):
    xl, yl = pytree.tree_leaves(x), pytree.tree_leaves(y)
    assert len(xl) == len(yl)
    for a, b in zip(xl, yl):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_save_restore_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = _tree()
        mgr.save(10, t)
        step, got = mgr.restore_latest(t)
        assert step == 10
        _assert_tree_equal(t, got)
        # onto another dtype and device of the template, and a 0-d leaf stays 0-d
        like = {"a": torch.zeros(4, 8, dtype=torch.float64),
                "b": [torch.zeros(3), torch.tensor(0)]}
        got = mgr.restore(10, like, shardings="cpu")
        assert got["a"].dtype == torch.float64 and got["b"][1].shape == ()
        assert torch.equal(got["a"], t["a"].double())


def test_keep_n_garbage_collection():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _tree(s))
        assert mgr.all_steps() == [3, 4]


def test_async_save_and_wait():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(5, _tree(), blocking=False)
        mgr.wait()
        assert mgr.latest_step() == 5


def test_unfinished_tmp_dirs_ignored():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, _tree())
        os.makedirs(os.path.join(d, "step_00000002.tmp-deadbeef"))
        assert mgr.latest_step() == 1
        mgr.save(3, _tree())  # gc cleans orphans on the next save
        assert not any(".tmp-" in n for n in os.listdir(d))


def test_elastic_restore_with_explicit_sharding():
    """Checkpoints hold logical arrays: restore onto any placement, a device
    or a mesh, one for every leaf or a tree of them."""
    mesh = make_node_data_mesh(2, n_shards=8, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4),
             "v": torch.arange(8, dtype=torch.int32)}
        mgr.save(1, t)
        for shardings in ({"v": data_mesh(8, "cpu"), "w": mesh}, mesh, "cpu"):
            got = mgr.restore(1, t, shardings=shardings)
            _assert_tree_equal(t, got)
            assert all(x.device == mesh.device for x in got.values())
        step, got = mgr.restore_latest(t, shardings={"v": "cpu", "w": mesh})
        assert step == 1
        _assert_tree_equal(t, got)
        with pytest.raises(ValueError, match="placements"):
            mgr.restore(1, t, shardings={"w": mesh})


def test_restore_mismatched_tree_raises():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, _tree())
        with pytest.raises(ValueError):
            mgr.restore(1, {"only_one": torch.zeros(3)})


# -- crash injection: the commit swap never loses a complete checkpoint -----------


class _SimulatedCrash(RuntimeError):
    pass


def _crashing_rename(monkeypatch, crash_on_call: int):
    """Make the ``crash_on_call``-th ``os.rename`` inside the manager raise,
    as if the process died there."""
    import repro_torch.checkpoint.manager as M

    real = os.rename
    calls = {"n": 0}

    def rename(src, dst):
        calls["n"] += 1
        if calls["n"] == crash_on_call:
            raise _SimulatedCrash(f"died at rename #{calls['n']}")
        return real(src, dst)

    monkeypatch.setattr(M.os, "rename", rename)
    return calls


def test_crash_before_any_rename_keeps_previous(monkeypatch):
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = _tree()
        mgr.save(1, t)
        _crashing_rename(monkeypatch, crash_on_call=1)
        with pytest.raises(_SimulatedCrash):
            mgr.save(2, _tree(2))
        monkeypatch.undo()
        step, got = CheckpointManager(d).restore_latest(t)  # a fresh process
        assert step == 1
        _assert_tree_equal(t, got)


def test_crash_between_swap_renames_rolls_back(monkeypatch):
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = _tree()
        mgr.save(1, t)  # overwritten below: the same step, a new payload
        _crashing_rename(monkeypatch, crash_on_call=2)
        with pytest.raises(_SimulatedCrash):
            mgr.save(1, _tree(99))
        monkeypatch.undo()
        assert any(".old-" in n for n in os.listdir(d))  # the only copy
        step, got = CheckpointManager(d).restore_latest(t)  # runs _recover
        assert step == 1
        _assert_tree_equal(_tree(), got)
        assert not any(".old-" in n for n in os.listdir(d))


def test_crash_after_commit_drops_old_copy(monkeypatch):
    import shutil as _shutil

    import repro_torch.checkpoint.manager as M

    real_rmtree = _shutil.rmtree
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = _tree()
        mgr.save(1, t)

        def boom(path, ignore_errors=False):
            raise _SimulatedCrash("died before deleting the old copy")

        monkeypatch.setattr(M.shutil, "rmtree", boom)
        with pytest.raises(_SimulatedCrash):
            mgr.save(1, _tree(99))
        monkeypatch.setattr(M.shutil, "rmtree", real_rmtree)
        assert any(".old-" in n for n in os.listdir(d))
        step, got = CheckpointManager(d).restore_latest(t)
        assert step == 1  # the new payload committed
        _assert_tree_equal(_tree(99), got)
        assert not any(".old-" in n for n in os.listdir(d))


def test_restore_latest_skips_partial_dirs():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = _tree()
        mgr.save(3, t)
        os.makedirs(os.path.join(d, "step_00000009.tmp-deadbeef"))
        os.makedirs(os.path.join(d, "step_00000007"))  # torn: no manifest
        step, _ = mgr.restore_latest(t)
        assert step == 3 and mgr.all_steps() == [3]


def test_concurrent_async_saves_and_restores():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=1)
        t = _tree()
        mgr.save(0, t)
        errors = []

        def writer():
            try:
                for s in range(1, 25):
                    mgr.save(s, _tree(s), blocking=False)
                    mgr.wait()
            except Exception as e:  # pragma: no cover - the failure path
                errors.append(e)

        wt = threading.Thread(target=writer)
        wt.start()
        try:
            while wt.is_alive():
                step, got = mgr.restore_latest(t)
                assert step is not None
                assert len(pytree.tree_leaves(got)) == len(pytree.tree_leaves(t))
        finally:
            wt.join(timeout=60)
        assert not wt.is_alive() and not errors


def test_blockstore_roundtrip_and_atomicity():
    with tempfile.TemporaryDirectory() as d:
        bs = BlockStore(d)
        bs.put("block_000001", b"abc" * 100)
        assert bs.has("block_000001") and bs.get("block_000001") == b"abc" * 100
        bs.put("block_000001", b"xyz")  # an overwrite is atomic (os.replace)
        assert bs.get("block_000001") == b"xyz"
        assert bs.bytes_written == 303
        assert not any(".tmp-" in n for n in os.listdir(d))
        bs.delete("block_000001")
        assert not bs.has("block_000001")
        bs.delete("block_000001")  # idempotent


# -- resume: run_loop and run_stream -------------------------------------------------


def _points():
    return np.random.RandomState(4).randint(-20, 20, size=(900, 4)).astype(np.float32)


@pytest.mark.parametrize("unroll", [1, 2])
def test_run_loop_resume_bit_equal(unroll):
    pts = _points()
    sess = BlazeSession(device="cpu")
    step, state0 = _kmeans_step(sess.distribute(pts), 5, 4, "pallas", "none")
    c0 = torch.as_tensor(pts[:5])
    full, _ = sess.run_loop(sess.program(step), state0(c0), max_iters=6, unroll=unroll)
    with tempfile.TemporaryDirectory() as d:
        _, first = sess.run_loop(sess.program(step), state0(c0), max_iters=4,
                                 unroll=unroll, checkpoint=d, checkpoint_every=2)
        assert first.resumed_from is None and CheckpointManager(d).latest_step() == 4
        got, info = sess.run_loop(sess.program(step), state0(c0), max_iters=6,
                                  unroll=unroll, checkpoint=d, resume=True)
    assert info.resumed_from == 4 and info.iterations == 2
    for k in full:
        assert torch.equal(full[k], got[k]), k
    js = JaxSession()
    jstep, jstate0 = _jkmeans_step(JC.distribute(pts, js.mesh), 5, 4, "pallas", "none")
    jout, _ = js.run_loop(js.program(jstep), jstate0(jnp.asarray(pts[:5])), max_iters=6,
                          unroll=unroll)
    np.testing.assert_array_equal(got["centers"].numpy(), np.asarray(jout["centers"]))


def test_run_loop_checkpointed_on_one_node_resumes_on_two_nodes():
    """Elastic resume: 4 iterations on a (1x8) mesh, checkpointed, then 2 more
    on a (2x4) mesh (its sums hierarchical) equal 6 uninterrupted (2x4)
    iterations bit for bit: the points are integer-valued, so every sum is
    exact in any order, and the state is logical."""
    pts = _points()
    flat = BlazeSession(mesh=make_node_data_mesh(1, n_shards=8, device="cpu"))
    two = BlazeSession(mesh=make_node_data_mesh(2, n_shards=8, device="cpu"))
    c0 = torch.as_tensor(pts[:5])

    def program(sess):
        step, state0 = _kmeans_step(sess.distribute(pts), 5, 4, "pallas", "none")
        return sess.program(step), state0(c0)

    prog, state = program(two)
    full, _ = two.run_loop(prog, state, max_iters=6, unroll=2)
    assert any(n.hier for n in prog.plan.mapreduce_nodes())
    with tempfile.TemporaryDirectory() as d:
        flat.run_loop(*program(flat), max_iters=4, unroll=2, checkpoint=d,
                      checkpoint_every=2)
        prog, state = program(two)
        got, info = two.run_loop(prog, state, max_iters=6, unroll=2, checkpoint=d,
                                 resume=True)
    assert info.resumed_from == 4 and info.iterations == 2
    for k in full:
        assert torch.equal(full[k], got[k]), k


def test_run_loop_resume_without_a_checkpoint_starts_over():
    pts = _points()
    sess = BlazeSession(device="cpu")
    step, state0 = _kmeans_step(sess.distribute(pts), 5, 4, "eager", "none")
    c0 = torch.as_tensor(pts[:5])
    full, _ = sess.run_loop(sess.program(step), state0(c0), max_iters=3)
    with tempfile.TemporaryDirectory() as d:
        got, info = sess.run_loop(sess.program(step), state0(c0), max_iters=3,
                                  checkpoint=d, resume=True)
    assert info.resumed_from is None and info.iterations == 3
    assert torch.equal(full["centers"], got["centers"])


@pytest.mark.parametrize("prefetch", [True, False])
def test_run_stream_resume_bit_equal(prefetch):
    pts = _points()
    sess = BlazeSession(device="cpu")
    cv = sess.chunked(pts, block_rows=256)
    step, state0 = _kmeans_stream_step(cv, 5, 4, "pallas", "none", sess.device)
    c0 = torch.as_tensor(pts[:5])
    full, _ = sess.run_stream(sess.program(step), state0(c0), max_epochs=5,
                              prefetch=prefetch)
    with tempfile.TemporaryDirectory() as d:
        sess.run_stream(sess.program(step), state0(c0), max_epochs=2, checkpoint=d,
                        checkpoint_every=1, prefetch=prefetch)
        assert CheckpointManager(d).all_steps() == [1, 2]
        got, info = sess.run_stream(sess.program(step), state0(c0), max_epochs=5,
                                    checkpoint=d, checkpoint_every=1, resume=True,
                                    prefetch=prefetch)
    assert info.resumed_from == 2 and info.epochs == 5
    assert info.dispatches == 3 * cv.n_blocks
    for k in full:
        assert torch.equal(full[k], got[k]), k


def test_run_stream_resume_restores_the_hash_carry():
    lines = np.random.RandomState(5).randint(0, 40, size=(600, 8)).astype(np.int32)
    sess = BlazeSession(device="cpu")
    cv = sess.chunked(lines, block_rows=128)

    def run(epochs, d=None, resume=False):
        hm = sess.make_dist_hashmap(160, (), torch.int32, "sum")
        step, state = _wc_step(cv, hm, 40, "pallas")
        prog = sess.program(step)
        state, info = sess.run_stream(prog, state, max_epochs=epochs, checkpoint=d,
                                      checkpoint_every=1 if d else None, resume=resume)
        return prog.hash_result(hm), state, info

    full, fstate, _ = run(3)
    with tempfile.TemporaryDirectory() as d:
        run(2, d)
        got, state, info = run(3, d, resume=True)
    assert info.resumed_from == 2
    assert int(state["it"]) == int(fstate["it"]) == 3 * cv.n_blocks
    assert got.to_dict() == full.to_dict()
    counts = np.bincount(lines.reshape(-1), minlength=40)
    assert got.to_dict() == {k: 3 * int(c) for k, c in enumerate(counts) if c}
