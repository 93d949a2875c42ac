"""Checkpoints of sharded LM state, and ``train`` over a ``DTensor`` tree,
on the CPU.

Every multi-process case runs real processes over ``gloo``
(``launch.simulate.spawn_local``):

* The mirror of ``tests/test_checkpoint.py::test_elastic_restore_with_explicit_sharding``:
  a plain tree saved by one process, restored by 2 onto
  ``sharding.NamedSharding(mesh, P("data", None))``.
* Reduced qwen3-0.6b (d_model 64, d_ff 128) in bf16, its parameters and
  AdamW state (moments and step filled from a seed) at ``param_pspecs`` /
  ``opt_pspecs`` on a (2 data, 2 model) mesh of 4 processes, saved; then
  restored onto (2, 2), (4, 1) and (1, 4) on 4 processes, onto (1, 2) on 2,
  and into a plain tree in this process.  Every leaf's logical array is the
  saved one bit for bit, bf16 included; each shard is written once.  A
  rank whose write fails mid-save leaves the previous checkpoint (as
  ``tests/test_torch_multiprocess_stream.py`` checks for row-sharded
  carries); a ``Partial`` leaf raises.
* ``train(params=<DTensor tree>)`` on (2, 2), 4 steps of 4 × 16 tokens,
  a checkpoint every 2, ``grad_accum`` 1 and 2: a run crashed at step 3
  and resumed is the uninterrupted run bit for bit (losses, and the final
  checkpoint's leaves).  The losses agree within ``rtol = 1e-5`` with the
  port's unsharded ``train`` and ``1e-4`` with the reference's ``train``
  on the same parameters ``device_put`` onto its ``NamedSharding``\\ s over
  4 forced CPU devices (a subprocess, run beside the processes), the bounds
  of ``tests/test_torch_sharded_lm.py``: the sharded step sums the same
  products in other orders (partial sums over model, the vocab-parallel
  log-sum-exp, gradients reduce-scattered), ~1e-6 relative an op, and XLA
  adds its own.  ``weight_decay = 0`` on both sides (the reference decays
  its stacked norm scales, ROADMAP Queue 3 item 13).
* The (2, 2) run's step-2 checkpoint resumed by ``train`` on (1, 4) and by
  the unsharded ``train``: their losses within the same ``1e-5`` of the
  uninterrupted run's.

The reference's subprocess also records where its resumed state lands:
its ``train`` restores with no ``shardings``, so every leaf comes back on
one device (ROADMAP Queue 3 item 21); the port keeps the live tree's
placements.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import manager as CM
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_arch
from repro_torch.launch.simulate import spawn_local

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, S, EVERY, CRASH = 4, 4, 16, 2, 3
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}


def _cfg(dtype: str = "float32"):
    return dataclasses.replace(get_arch("qwen3-0.6b").reduced(), d_model=64, d_ff=128,
                               param_dtype=dtype)


def _state():
    """The bf16 parameters and AdamW state the checkpoint cases save, as
    ``runtime.train_loop`` checkpoints them (the same tree in every
    process)."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import _ckpt_tree

    params = M.init(torch.Generator().manual_seed(0), _cfg("bfloat16"))
    opt = AdamW().init(params)
    rng = np.random.RandomState(1)
    for t in M.distinct_leaves(opt["m"]) + M.distinct_leaves(opt["v"]):
        t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)))
    opt["step"].fill_(7)
    return params, opt, _ckpt_tree(params, opt)


def _on_mesh(params, opt, mesh):
    """``(params, opt)`` as ``DTensor``s at ``param_pspecs`` / ``opt_pspecs``
    on ``mesh``, in the checkpoint's tree."""
    from repro_torch import convert
    from repro_torch.distributed import sharding as SH
    from repro_torch.runtime.train_loop import _ckpt_tree

    mi = SH.make_mesh_info(mesh)
    pspecs = SH.param_pspecs(_cfg("bfloat16"), params, mi)
    return _ckpt_tree(convert.distribute(params, pspecs, mesh),
                      convert.distribute(opt, SH.opt_pspecs(pspecs, opt), mesh))


def _zeros(params, opt):
    from repro_torch.models import model as M

    return (M.map_tree(torch.zeros_like, params),
            {k: M.map_tree(torch.zeros_like, v) for k, v in opt.items()})


def _held(got, like, want) -> dict:
    """``got`` (restored onto ``like``'s placements) against the plain tree
    ``want``: leaves, whether each kept ``like``'s placements and dtype,
    whether each whole leaf is ``want``'s bit for bit, and how many are
    sharded."""
    from torch.distributed.tensor import DTensor, Shard

    g, lk, w = (pytree.tree_leaves(t) for t in (got, like, want))
    return {
        "leaves": len(g),
        "placed": all(isinstance(a, DTensor) and a.placements == b.placements
                      and a.dtype == b.dtype for a, b in zip(g, lk)),
        "equal": all(torch.equal(a.full_tensor(), c) for a, c in zip(g, w)),
        "sharded": sum(any(isinstance(p, Shard) for p in a.placements) for a in g),
    }


def _train_kw(accum: int, params):
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.optim.adamw import AdamW

    cfg = _cfg()
    return dict(steps=STEPS, batch=B, seq_len=S, ckpt_every=EVERY, grad_accum=accum,
                pipeline=TokenPipeline(cfg, batch=B, seq_len=S), params=params,
                optimizer=AdamW(lr=1e-3, weight_decay=0.0))


def _sharded_params(params_np, mesh):
    from repro_torch import convert
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.distributed import sharding as SH

    params = lm_params_from_jax(params_np, _cfg(), "cpu")
    return convert.distribute(params, SH.param_pspecs(_cfg(), params,
                                                      SH.make_mesh_info(mesh)), mesh)


def _four(rank, root, params_np):
    """One rank of 4: the bf16 state saved on (2, 2) and restored onto
    (2, 2), (4, 1), (1, 4); a Partial leaf; a failed save; then the
    sharded training runs."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import train_loop as T

    torch.set_num_threads(1)
    out = {}
    params, opt, want = _state()
    meshes = {name: make_mesh(shape, ("data", "model"), device="cpu")
              for name, shape in MESHES.items()}
    mesh = meshes["2x2"]
    tree = _on_mesh(params, opt, mesh)
    mgr = CheckpointManager(os.path.join(root, "state"))
    mgr.save(2, tree)
    for name, m in meshes.items():
        like = _on_mesh(*_zeros(params, opt), m)
        out[name] = _held(mgr.restore(2, like), like, want)

    partial = DTensor.from_local(torch.ones(2), mesh, [Partial(), Replicate()])
    try:
        mgr.save(3, {"x": partial})
        out["partial"] = None
    except ValueError as e:
        out["partial"] = str(e)

    fail = CheckpointManager(os.path.join(root, "fail"))
    fail.save(2, tree)
    real = CM._write_raw

    def write_raw(path, arrays):
        if rank == 1:
            raise OSError("rank 1's disk fails in the middle of the save")
        return real(path, arrays)

    CM._write_raw = write_raw
    try:
        fail.save(4, _on_mesh(*_zeros(params, opt), mesh))
        err = None
    except (OSError, RuntimeError) as e:
        err = f"{type(e).__name__}: {e}"
    finally:
        CM._write_raw = real
    like = _on_mesh(*_zeros(params, opt), mesh)
    step, got = fail.restore_latest(like)
    out["fail"] = (err, sorted(os.listdir(fail.dir)), step, _held(got, like, want))

    try:
        T.train(_cfg(), ckpt_dir=os.path.join(root, "meta"), device="meta",
                **_train_kw(1, _sharded_params(params_np, mesh)))
        out["device"] = None
    except ValueError as e:
        out["device"] = str(e)

    for accum in (1, 2):
        for run, crash in (("whole", None), ("crash", CRASH)):
            res = T.train(_cfg(), ckpt_dir=os.path.join(root, f"{run}{accum}"),
                          crash_at_step=crash, **_train_kw(accum, _sharded_params(params_np,
                                                                                  mesh)))
            out[f"{run}{accum}"] = {"losses": res.losses, "restarts": res.restarts,
                                    "steps_run": res.steps_run,
                                    "checkpoints": [(c["step"], c["kind"])
                                                    for c in res.checkpoints]}
    if rank == 0:
        shutil.copytree(os.path.join(root, "whole1", "step_00000002"),
                        os.path.join(root, "on1x4", "step_00000002"))
    dist.barrier()
    res = T.train(_cfg(), ckpt_dir=os.path.join(root, "on1x4"),
                  **_train_kw(1, _sharded_params(params_np, meshes["1x4"])))
    out["on1x4"] = {"losses": res.losses, "steps_run": res.steps_run}
    return out


def _two(rank, root):
    """One rank of 2: the plain tree restored onto NamedSharding(mesh,
    P("data", None)); the (2, 2) checkpoint restored onto (1, 2)."""
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    out = {}
    mesh = make_mesh((2,), ("data",), device="cpu")
    sh = {"w": NamedSharding(mesh, P("data", None))}
    like = {"w": torch.zeros(4, 4)}
    got = CheckpointManager(os.path.join(root, "plain")).restore(1, like, shardings=sh)
    w = got["w"]
    out["mirror"] = (type(w).__name__, str(w.placements), w.full_tensor().numpy(),
                     w.to_local().numpy())
    params, opt, want = _state()
    like = _on_mesh(*_zeros(params, opt), make_mesh((1, 2), ("data", "model"), device="cpu"))
    out["1x2"] = _held(CheckpointManager(os.path.join(root, "state")).restore(2, like),
                       like, want)
    return out


# The reference's train on the same parameters over 4 forced CPU devices:
# uninterrupted with grad_accum 1 and 2, and crashed at step 3 (where its
# resumed state lands recorded).
_JAX = r"""
import dataclasses, json, pickle, sys
import numpy as np, jax
from repro.compat import AxisType, make_mesh, set_mesh
from repro.checkpoint import manager as CM
from repro.configs.base import get_arch
from repro.data.pipeline import TokenPipeline
from repro.distributed import sharding as SH
from repro.optim.adamw import AdamW
from repro.runtime import train_loop as T
assert len(jax.devices()) == 4
cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), d_model=64, d_ff=128)
with open(sys.argv[1], "rb") as f:
    params_np = pickle.load(f)
mesh = make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
mi = SH.make_mesh_info(mesh)
named = SH.named(SH.param_pspecs(cfg, params_np, mi), mi)
want = jax.tree.leaves(named)
restored = []
real = CM.CheckpointManager.restore_latest
def watched(self, like, shardings=None):
    step, tree = real(self, like, shardings)
    if tree is not None:
        got = jax.tree.leaves(tree["params"])
        restored.append({"step": step, "leaves": len(got),
                         "one_device": sum(len(x.sharding.device_set) == 1 for x in got),
                         "kept": sum(x.sharding == s for x, s in zip(got, want))})
    return step, tree
CM.CheckpointManager.restore_latest = watched
out = {}
kw = dict(steps=%d, batch=%d, seq_len=%d, ckpt_every=%d)
with set_mesh(mesh):
    for accum, crash in ((1, None), (2, None), (1, %d)):
        res = T.train(cfg, pipeline=TokenPipeline(cfg, batch=%d, seq_len=%d),
                      ckpt_dir=f"{sys.argv[2]}/{accum}-{crash}", crash_at_step=crash,
                      params=jax.device_put(params_np, named), grad_accum=accum,
                      optimizer=AdamW(lr=1e-3, weight_decay=0.0), **kw)
        out[f"{accum}-{crash}"] = res.losses
out["restored"] = restored
print(json.dumps(out))
""" % (STEPS, B, S, EVERY, CRASH, B, S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results of the 4- and 2-process runs, the reference's
    run, the initial parameters (numpy) and the checkpoints' root."""
    import jax

    from repro.configs.base import get_arch as jget_arch
    from repro.models import model as JM

    root = str(tmp_path_factory.mktemp("sharded_ckpt"))
    jcfg = dataclasses.replace(jget_arch("qwen3-0.6b").reduced(), d_model=64, d_ff=128)
    params_np = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), jcfg))
    path = os.path.join(root, "params.pkl")
    with open(path, "wb") as f:
        pickle.dump(params_np, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _JAX, path, os.path.join(root, "jax")],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env=env)
    try:
        CheckpointManager(os.path.join(root, "plain")).save(
            1, {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)})
        four = spawn_local(4, _four, root, params_np, timeout=600)
        two = spawn_local(2, _two, root, timeout=300)
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, stderr[-3000:]
    return {"four": four, "two": two, "jax": json.loads(stdout.strip().splitlines()[-1]),
            "params_np": params_np, "root": root}


def test_plain_checkpoint_restores_onto_a_named_sharding(runs):
    """Mirrors ``tests/test_checkpoint.py::test_elastic_restore_with_explicit_sharding``
    on a ``DeviceMesh`` of 2 processes."""
    want = np.arange(16, dtype=np.float32).reshape(4, 4)
    for rank, res in enumerate(runs["two"]):
        kind, placements, whole, local = res["mirror"]
        assert kind == "DTensor" and placements == "(Shard(dim=0),)"
        np.testing.assert_array_equal(whole, want)
        np.testing.assert_array_equal(local, want[2 * rank:2 * rank + 2])


@pytest.mark.parametrize("target", ["2x2", "4x1", "1x4", "1x2", "plain"])
def test_sharded_state_restores_onto_any_mesh(runs, target):
    """The (2, 2) checkpoint of bf16 parameters and f32 moments, bit for bit
    on every rank of every target (and whole in one process)."""
    if target == "plain":
        params, opt, want = _state()
        got = CheckpointManager(os.path.join(runs["root"], "state")).restore(
            2, _ckpt_tree_zeros(params, opt))
        g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
        assert len(g) == len(w) and all(type(a) is torch.Tensor for a in g)
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(g, w))
        assert any(a.dtype == torch.bfloat16 for a in g)
        return
    ranks = runs["two"] if target == "1x2" else runs["four"]
    for res in ranks:
        held = res[target]
        assert held["placed"] and held["equal"], held
        assert held["leaves"] == len(pytree.tree_leaves(_state()[2]))
        # the target's own layout, not the (2, 2) one: leaves really move
        assert held["sharded"] > 0


def _ckpt_tree_zeros(params, opt):
    from repro_torch.runtime.train_loop import _ckpt_tree

    return _ckpt_tree(*_zeros(params, opt))


def test_each_shard_is_written_once_and_the_plain_format_is_unchanged(runs):
    root = runs["root"]
    with open(os.path.join(root, "state", "step_00000002", "MANIFEST.json")) as f:
        manifest = json.load(f)
    boxes = manifest["boxes"]
    assert len(boxes) == manifest["n_leaves"]  # every leaf a DTensor
    ends = {}  # file -> bytes its boxes take
    for i, shape in enumerate(manifest["shapes"]):
        parts = boxes[str(i)]
        # disjoint boxes that tile the leaf: their sizes sum to its size
        assert sum(int(np.prod(s)) for _, _, s, _ in parts) == int(np.prod(shape))
        assert len({tuple(o) for _, o, _, _ in parts}) == len(parts)
        size = 2 if manifest["dtypes"][i] == "bfloat16" else np.dtype(
            manifest["dtypes"][i]).itemsize
        for name, _, s, at in parts:
            assert at == ends.get(name, 0)  # each file its boxes back to back
            ends[name] = at + int(np.prod(s)) * size
    step_dir = os.path.join(root, "state", "step_00000002")
    files = sorted(os.listdir(step_dir))
    assert files == ["MANIFEST.json"] + [f"rank_{r:05d}.bin" for r in range(4)]
    assert all(os.path.getsize(os.path.join(step_dir, f)) == n for f, n in ends.items())
    # the step (replicated) only in rank 0's file
    step_leaf = len(boxes) - 1
    assert manifest["shapes"][step_leaf] == [] and \
        [b[0] for b in boxes[str(step_leaf)]] == ["rank_00000.bin"]
    assert {"bfloat16", "float32", "int32"} == set(manifest["dtypes"])
    plain = os.path.join(root, "plain", "step_00000001")
    assert sorted(os.listdir(plain)) == ["MANIFEST.json", "arrays.npz"]
    with open(os.path.join(plain, "MANIFEST.json")) as f:
        assert set(json.load(f)) == {"step", "n_leaves", "treespec", "shapes", "dtypes"}


def test_a_partial_leaf_raises(runs):
    for res in runs["four"]:
        assert res["partial"] is not None and "Partial" in res["partial"]


def test_a_rank_failing_mid_save_leaves_the_previous_checkpoint(runs):
    errors = [res["fail"][0] for res in runs["four"]]
    assert errors[1].startswith("OSError: rank 1's disk fails")
    for r in (0, 2, 3):
        assert errors[r].startswith("RuntimeError: checkpoint 4 was not committed: "
                                    "rank(s) [1]")
    for _err, listing, step, held in (res["fail"] for res in runs["four"]):
        assert listing == ["step_00000002"]  # no tmp- directory left behind
        assert step == 2 and held["placed"] and held["equal"]


def test_restore_onto_a_mesh_whose_group_is_down_raises(tmp_path):
    from repro_torch.distributed.sharding import NamedSharding, P

    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4)})
    mesh = types.SimpleNamespace(mesh_dim_names=("data",))
    with pytest.raises(RuntimeError, match="not up"):
        mgr.restore(1, {"w": torch.zeros(4)}, shardings={"w": NamedSharding(mesh, P("data"))})
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, {"w": torch.zeros(4), "b": torch.zeros(1)})


def test_train_refuses_a_device_off_the_parameters_mesh(runs):
    for res in runs["four"]:
        assert res["device"] is not None and "meta" in res["device"]


@pytest.mark.parametrize("accum", [1, 2])
def test_sharded_train_resumes_bit_for_bit(runs, accum):
    from repro_torch.runtime.train_loop import _ckpt_tree

    for res in runs["four"]:
        whole, crash = res[f"whole{accum}"], res[f"crash{accum}"]
        assert whole == runs["four"][0][f"whole{accum}"]  # every rank the same
        assert whole["restarts"] == 0 and crash["restarts"] == 1
        assert crash["steps_run"] == CRASH + (STEPS - EVERY)
        assert crash["losses"] == whole["losses"][:CRASH] + whole["losses"][EVERY:]
        assert crash["checkpoints"] == [(2, "save"), (2, "restore"), (4, "save")]
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.optim.adamw import AdamW

    params = lm_params_from_jax(runs["params_np"], _cfg(), "cpu")
    like = _ckpt_tree(params, AdamW().init(params))
    root = runs["root"]
    got = CheckpointManager(os.path.join(root, f"crash{accum}")).restore(STEPS, like)
    want = CheckpointManager(os.path.join(root, f"whole{accum}")).restore(STEPS, like)
    pairs = list(zip(pytree.tree_leaves(got), pytree.tree_leaves(want)))
    assert pairs and all(torch.equal(a, b) for a, b in pairs)


@pytest.mark.parametrize("accum", [1, 2])
def test_sharded_train_matches_unsharded_and_the_reference(runs, tmp_path, accum):
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.runtime import train_loop as T

    losses = runs["four"][0][f"whole{accum}"]["losses"]
    plain = lm_params_from_jax(runs["params_np"], _cfg(), "cpu")
    want = T.train(_cfg(), ckpt_dir=str(tmp_path), device="cpu",
                   **_train_kw(accum, plain)).losses
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    np.testing.assert_allclose(losses, runs["jax"][f"{accum}-None"], rtol=1e-4)
    assert losses[-1] < losses[0]


def test_a_checkpoint_resumes_on_another_mesh_and_unsharded(runs, tmp_path):
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.runtime import train_loop as T

    whole = runs["four"][0]["whole1"]["losses"]
    for res in runs["four"]:
        assert res["on1x4"]["steps_run"] == STEPS - EVERY
        np.testing.assert_allclose(res["on1x4"]["losses"], whole[EVERY:], rtol=1e-5)
    shutil.copytree(os.path.join(runs["root"], "whole1", "step_00000002"),
                    os.path.join(tmp_path, "step_00000002"))
    plain = lm_params_from_jax(runs["params_np"], _cfg(), "cpu")
    res = T.train(_cfg(), ckpt_dir=str(tmp_path), device="cpu", **_train_kw(1, plain))
    assert res.steps_run == STEPS - EVERY
    np.testing.assert_allclose(res.losses, whole[EVERY:], rtol=1e-5)


def test_the_reference_resumes_its_sharded_state_on_one_device(runs):
    """What the reference does (ROADMAP Queue 3 item 21): its ``train``
    restores with no ``shardings``, so every leaf of the resumed state lands
    on one device, none keeping its ``NamedSharding``; the port's resumed
    state keeps its placements (the cases above)."""
    (rec,) = runs["jax"]["restored"]
    assert rec["step"] == EVERY and rec["one_device"] == rec["leaves"] > 0
    assert rec["kept"] == 0
    np.testing.assert_allclose(runs["jax"][f"1-{CRASH}"][CRASH:],
                               runs["jax"]["1-None"][EVERY:], rtol=1e-4)
