"""Explicit data-parallel training with compressed gradients
(``repro_torch.distributed.dp_train``) against the reference's
``repro.distributed.dp_train`` on 8 shards: the wire-byte accounting,
convergence parity between the exact and the int8 wire (mirrors
``tests/test_grad_compression.py``), and the first two steps against the
reference's run on 8 forced CPU devices in a subprocess.

The two steps run reduced qwen3-0.6b in f32 with ``AdamW(lr=2e-3,
weight_decay=0, eps=1e-3)``: no decay, as the reference decays its stacked
1-D leaves (ROADMAP Queue 3 item 13), and an ``eps`` that bounds the slope
of a step in its gradient by ``1/eps`` (``tests/test_torch_train_loop.py``).
Tolerances: the losses, means of O(1) log-likelihoods in f32, within
``rtol = 1e-5``.  The parameters after each step: with ``wire="none"`` the
two packages' gradient means differ by f32 rounding, up to ~3e-8 absolute
(the tied embedding's rows sum the head's gradient over every position),
which moves a parameter by at most ``lr·3e-8/eps = 6e-8``: ``atol =
1e-4·lr = 2e-7``.  The int8 wire frames the reference's leaves (``cfg=``:
a stage slot's gradient over both stages shares one scale).
With ``wire="int8"`` a shard's gradient is rounded to a lattice of
``max|g|/127``; a rounding off by an ulp can land a value on the other side
of a half step, moving that sum by one lattice step, so all but 1% of each
leaf's entries (or 2, where that is more) are held as above and every
entry within ``2·lr`` (an AdamW step moves
a parameter by at most ``lr·|m̂|/(√v̂ + eps) ≤ lr`` each step).  The second
step reads the residuals the first left: the reference keeps one a device
(its "replicated" output holds a different buffer on each), the port one a
shard, so the second step agrees only if each shard reads its own.
With ``wire="bf16"`` both packages round each shard's gradient to bf16 and
add the 8 partials in bf16, each in its own order (the port in shard order,
rounding at every addition; XLA's CPU all-reduce in its own), so a sum may
differ by a bf16 rounding in any entry, not only at rare boundaries, and a
first Adam step scales a gradient difference by up to ``1/eps``: every
entry is held within the steps' reach, ``2·lr``, and the loss as above.

Across processes (``spawn_local``: 2 and 4 ``gloo`` processes, one node row
each, 8 shards in all): every rank's losses, parameters and AdamW state
equal the in-process ``data_mesh(8)`` run bit for bit under every wire,
each rank's residual rows equal that run's rows of its shards, and the
results are held to JAX's 8-device run with the bounds above.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.distributed import dp_train as JD
from repro.models import model as JM
from repro_torch.configs.base import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.containers import data_mesh
from repro_torch.distributed.dp_train import (
    grad_wire_bytes,
    init_residuals,
    make_dp_train_step,
)
from repro_torch.launch.simulate import spawn_local
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
LR = 2e-3
WIRES = ("none", "bf16", "int8")
PROCS = (2, 4)  # processes, one node row each, of the 8 shards

_REFERENCE = """
import json, sys, numpy as np, jax, jax.numpy as jnp
from repro.configs.base import get_arch
from repro.core.containers import data_mesh
from repro.distributed.dp_train import init_residuals, make_dp_train_step
from repro.models import model as M
from repro.optim.adamw import AdamW

cfg = get_arch("qwen3-0.6b").reduced()
mesh = data_mesh()
assert mesh.shape["data"] == 8
opt = AdamW(lr=%(lr)r, weight_decay=0.0, eps=1e-3)

def loss_fn(params, inputs, labels):
    return M.loss_fn(params, cfg, inputs, labels, remat=False)

out, arrays = {}, {}
for wire in ("none", "bf16", "int8"):
    params = M.init(jax.random.PRNGKey(0), cfg)
    ostate = opt.init(params)
    resid = init_residuals(params)
    step = make_dp_train_step(loss_fn, opt, mesh, wire=wire)
    rng = np.random.RandomState(0)
    losses = []
    for i in range(2):
        toks = jnp.asarray(rng.randint(0, cfg.vocab, (8, 16)), jnp.int32)
        params, ostate, resid, loss = step(params, ostate, resid,
                                           {"inputs": toks, "labels": toks})
        losses.append(float(loss))
        for j, leaf in enumerate(jax.tree.leaves(params)):
            arrays[f"{wire}_{i}_{j}"] = np.asarray(leaf)
    out[wire] = losses
np.savez(sys.argv[1], **arrays)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's losses and parameters after steps 1 and 2, per wire."""
    path = str(tmp_path_factory.mktemp("dp") / "params.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    p = subprocess.run([sys.executable, "-c", _REFERENCE % {"lr": LR}, path],
                       capture_output=True, text=True, env=env, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    losses = json.loads(p.stdout.strip().splitlines()[-1])
    cfg_j = jget_arch("qwen3-0.6b").reduced()
    treedef = jax.tree.structure(JM.init(jax.random.PRNGKey(0), cfg_j))
    with np.load(path) as f:
        params = {(wire, i): jax.tree.unflatten(treedef, [
            f[f"{wire}_{i}_{j}"] for j in range(treedef.num_leaves)])
            for wire in WIRES for i in range(2)}
    return losses, params


def _tokens(rng, cfg):
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (8, 16)).astype(np.int32))
    return {"inputs": toks, "labels": toks}


def _loss_fn(cfg):
    def loss_fn(params, inputs, labels):
        return M.loss_fn(params, cfg, inputs, labels, remat=False)

    return loss_fn


def test_grad_wire_bytes_accounting():
    """Mirrors ``tests/test_grad_compression.py::test_grad_wire_bytes_accounting``."""
    params = {"w": torch.zeros((1000, 10), dtype=torch.float32)}
    assert grad_wire_bytes(params, "none") == 40_000
    assert grad_wire_bytes(params, "bf16") == 20_000
    # int8 frames ship the shared f32 scale alongside the lattice
    assert grad_wire_bytes(params, "int8") == 10_000 + 4


@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
def test_grad_wire_bytes_count_zamba2_shared_block_once(wire):
    """The shared block is one gradient, one entry of the JAX tree."""
    cfg_j, cfg_t = jget_arch("zamba2-7b").reduced(), get_arch("zamba2-7b").reduced()
    params_j = JM.init(jax.random.PRNGKey(0), cfg_j)
    params_t = lm_params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, CPU)
    # with the config, the frames are JAX's stacked leaves (one int8 scale
    # each); without it, each of the port's tensors is a frame
    assert grad_wire_bytes(params_t, wire, cfg_t) == JD.grad_wire_bytes(params_j, wire)
    frames = len(M.distinct_leaves(params_t)) if wire == "int8" else 0
    assert grad_wire_bytes(params_t, wire) == (
        M.param_count(params_t) * {"none": 4, "bf16": 2, "int8": 1}[wire] + 4 * frames)


def test_compressed_training_convergence_parity_8_shards():
    """Mirrors ``tests/test_grad_compression.py::
    test_compressed_training_convergence_parity_8dev`` on an 8-shard
    ``data_mesh`` on the CPU, with the reference's assertions."""
    cfg = get_arch("qwen3-0.6b").reduced()
    mesh = data_mesh(8, device="cpu")
    opt = AdamW(lr=2e-3)
    out = {}
    for wire in ("none", "int8"):
        params = M.init(torch.Generator().manual_seed(0), cfg)
        ostate = opt.init(params)
        resid = init_residuals(params, mesh)
        step = make_dp_train_step(_loss_fn(cfg), opt, mesh, wire=wire)
        rng = np.random.RandomState(0)
        losses = []
        for _ in range(20):
            params, ostate, resid, loss = step(params, ostate, resid, _tokens(rng, cfg))
            losses.append(float(loss))
        out[wire] = losses
    exact, comp = out["none"], out["int8"]
    assert comp[-1] < comp[0], "compressed run must converge"
    # int8 + error feedback tracks the exact wire closely
    assert abs(comp[-1] - exact[-1]) / exact[-1] < 0.05, (exact[-1], comp[-1])


def _hold_to_reference(reference, wire, i, loss, params, cfg):
    """Step ``i``'s loss and parameters against the reference's (module
    docstring's bounds)."""
    losses_j, params_j = reference
    np.testing.assert_allclose(float(loss), losses_j[wire][i], rtol=1e-5)
    want = M.distinct_leaves(lm_params_from_jax(params_j[(wire, i)], cfg, CPU))
    for got, w in zip(params, want):
        err = (torch.as_tensor(got).detach() - w).abs()
        if wire == "none":
            assert float(err.max()) <= 1e-4 * LR
        else:
            assert float(err.max()) <= 2 * LR
            if wire == "int8":
                assert int((err > 1e-4 * LR).sum()) <= max(2, err.numel() // 100)


@pytest.mark.parametrize("wire", WIRES)
def test_first_two_steps_match_reference_8dev(reference, wire):
    cfg_j, cfg = jget_arch("qwen3-0.6b").reduced(), get_arch("qwen3-0.6b").reduced()
    mesh = data_mesh(8, device="cpu")
    opt = AdamW(lr=LR, weight_decay=0.0, eps=1e-3)
    params = lm_params_from_jax(jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0),
                                                                 cfg_j)), cfg, CPU)
    ostate = opt.init(params)
    resid = init_residuals(params, mesh)
    step = make_dp_train_step(_loss_fn(cfg), opt, mesh, wire=wire, cfg=cfg)
    rng = np.random.RandomState(0)
    for i in range(2):
        params, ostate, resid, loss = step(params, ostate, resid, _tokens(rng, cfg))
        _hold_to_reference(reference, wire, i, loss, M.distinct_leaves(params), cfg)
    if wire != "none":  # the residuals carry one row a shard, and they differ
        r = M.distinct_leaves(resid)[0]
        assert r.shape[0] == 8 and float((r - r[0]).abs().max()) > 0


# -- across processes ------------------------------------------------------------


def _dp_steps(mesh, wire, params0):
    """Two steps of reduced qwen3 on ``mesh`` from a copy of ``params0``:
    each step's loss and parameters, then the AdamW state and the
    residuals, as numpy."""
    cfg = get_arch("qwen3-0.6b").reduced()
    params = M.map_tree(lambda t: t.detach().clone(), params0)
    opt = AdamW(lr=LR, weight_decay=0.0, eps=1e-3)
    ostate = opt.init(params)
    resid = init_residuals(params, mesh)
    step = make_dp_train_step(_loss_fn(cfg), opt, mesh, wire=wire, cfg=cfg)
    rng = np.random.RandomState(0)
    out = {"losses": [], "params": []}
    for _ in range(2):
        params, ostate, resid, loss = step(params, ostate, resid, _tokens(rng, cfg))
        out["losses"].append(loss.detach().numpy().copy())
        out["params"].append([t.detach().numpy().copy() for t in M.distinct_leaves(params)])
    out["opt"] = [t.numpy().copy() for t in (*M.distinct_leaves(ostate["m"]),
                                             *M.distinct_leaves(ostate["v"]), ostate["step"])]
    out["resid"] = [t.numpy().copy() for t in M.distinct_leaves(resid)]
    return out


def _dp_rank(rank, params0):
    """One rank: its node row of the 8 shards, every wire."""
    from repro_torch.launch.mesh import make_node_data_mesh

    mesh = make_node_data_mesh(n_shards=8, device="cpu")
    assert mesh.process and mesh.rank == rank
    return {wire: _dp_steps(mesh, wire, params0) for wire in WIRES}


@pytest.fixture(scope="module")
def dp_processes():
    """The in-process 8-shard run and each topology's ranks, every wire,
    from JAX's initial parameters."""
    cfg_j, cfg = jget_arch("qwen3-0.6b").reduced(), get_arch("qwen3-0.6b").reduced()
    params = lm_params_from_jax(jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0),
                                                                 cfg_j)), cfg, CPU)
    local = {wire: _dp_steps(data_mesh(8, device="cpu"), wire, params)
             for wire in WIRES}
    ranks = {n: spawn_local(n, _dp_rank, params, timeout=300) for n in PROCS}
    return local, ranks


def _bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(np.atleast_1d(g).view(np.uint8),
                                      np.atleast_1d(w).view(np.uint8))


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("n_procs", PROCS)
def test_dp_train_across_processes_is_the_in_process_run(dp_processes, reference,
                                                         n_procs, wire):
    """Every rank: the in-process 8-shard run's losses, parameters and AdamW
    state bit for bit, its own shards' residual rows, and JAX's results
    within the module's bounds."""
    local, ranks = dp_processes
    want = local[wire]
    per = 8 // n_procs
    cfg = get_arch("qwen3-0.6b").reduced()
    for rank, res in enumerate(ranks[n_procs]):
        got = res[wire]
        _bit_equal(got["losses"], want["losses"])
        for i in range(2):
            _bit_equal(got["params"][i], want["params"][i])
        _bit_equal(got["opt"], want["opt"])
        _bit_equal(got["resid"], [r[rank * per:(rank + 1) * per] for r in want["resid"]])
    for i in range(2):
        _hold_to_reference(reference, wire, i, ranks[n_procs][0][wire]["losses"][i],
                           ranks[n_procs][0][wire]["params"][i], cfg)
    if wire != "none":  # the shards' residual rows differ, across the ranks too
        rows = np.concatenate([r[wire]["resid"][0] for r in ranks[n_procs]])
        assert rows.shape[0] == 8 and float(np.abs(rows - rows[0]).max()) > 0


def test_dp_train_refuses_a_multi_node_mesh():
    from repro_torch.core.containers import Mesh

    with pytest.raises(ValueError, match="1-D data mesh"):
        make_dp_train_step(_loss_fn(get_arch("qwen3-0.6b").reduced()), AdamW(),
                           Mesh(2, 4, CPU))
