"""The LM stack sharded over a (data, model) ``DeviceMesh``, on the CPU.

Every case runs ``P`` real processes over ``gloo``
(``launch.simulate.spawn_local``), the parameters and inputs carried
across as numpy arrays, the steps those ``launch.dryrun`` builds:

* (2 data, 4 model) in 8 processes, the reduced qwen3 of
  ``tests/test_multidevice.py::test_sharded_train_step_8dev`` (d_model 64,
  d_ff 128), 8 sharded train steps (``dryrun.make_train_step``: loss with
  remat, gradients at their parameters' placements, AdamW) from the
  reference's initial parameters, on that test's batches.  The losses are
  held against the port's unsharded ``runtime.train_loop.make_train_step``
  from the same state, and against the reference's own sharded run on 8
  forced CPU devices (a subprocess, as ``tests/test_multidevice.py`` runs
  it); the last loss must be below the first.  ``weight_decay=0`` on both
  sides: the reference decays its stacked norm scales, the port's one-layer
  scales are 1-D and not decayed (ROADMAP Queue 3 item 13).
* (2 data, 2 model) in 4 processes: a prefill of 12 tokens and 4 greedy
  decode steps (``dryrun.make_serve_steps``; the caches laid out by
  ``cache_pspecs`` for prefill, then resharded to the decode layout)
  against the unsharded port's ``prefill`` / ``decode_step`` on the same
  weights, for reduced qwen3, a reduced qwen3 with one kv head (it divides
  no model axis, so decode takes the ``"dh"`` layout: asserted through
  ``ops.attention.dh_plain_calls``), one with 3 query heads and one kv head
  (no head count divides: the prefill's query rows split over model, each
  rank's at its offset; decode "dh"), a reduced gemma2 with one kv head and
  a window of 8 (decode "dh" with a softcap, its local layers reading the
  window's view of the cache at an offset), reduced mixtral (MoE, dispatch
  groups = the dp size on both sides), reduced zamba2 and reduced rwkv6.

Tolerances (f32, the reduced configs' dtype): the sharded step sums the
same products in other orders (partial sums over model, the vocab-parallel
log-sum-exp, gradients reduce-scattered), ~1e-6 relative an op.  Losses
agree within ``rtol = 1e-5`` of the unsharded port's and ``rtol = 1e-4``
of the reference's (XLA's sums besides, and its chunked attention); the
parameters after 8 steps within ``1e-4`` of the largest (Adam's first
steps divide by ``sqrt(v)``, which magnifies the gradients' rounding where
they are tiny).  Logits agree within ``2e-4·max|logits| + 1e-5`` and
greedy tokens are equal.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import get_arch
from repro_torch.launch.simulate import spawn_local

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, B, S = 8, 4, 16
PROMPT, GEN = 12, 4  # a prompt longer than 8: prefill is never decode-like


def _train_cfg():
    return dataclasses.replace(get_arch("qwen3-0.6b").reduced(), d_model=64, d_ff=128)


def _batches(cfg):
    rng = np.random.RandomState(0)
    return [rng.randint(0, cfg.vocab, (B, S)).astype(np.int32) for _ in range(STEPS)]


# The reference's sharded train step on a (2 data, 4 model) mesh of 8 forced
# CPU devices (tests/test_multidevice.py::test_sharded_train_step_8dev, all
# losses printed, weight_decay=0), and its initial parameters.
_JAX = """
import json, numpy as np, jax, jax.numpy as jnp, dataclasses, pickle, sys
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs.base import get_arch
from repro.distributed import sharding as SH
from repro.models import model as M
from repro.optim.adamw import AdamW
assert len(jax.devices()) == 8
cfg = dataclasses.replace(get_arch("qwen3-0.6b").reduced(), d_model=64, d_ff=128)
mesh = make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,)*2)
mi = SH.make_mesh_info(mesh)
params = M.init(jax.random.PRNGKey(0), cfg)
with open(sys.argv[1], "wb") as f:
    pickle.dump(jax.tree.map(np.asarray, params), f)
pspecs = SH.param_pspecs(cfg, params, mi)
params = jax.device_put(params, SH.named(pspecs, mi))
opt = AdamW(lr=1e-3, weight_decay=0.0)
ostate = opt.init(params)
def step(p, o, x, y):
    loss, g = jax.value_and_grad(lambda q: M.loss_fn(q, cfg, x, y, remat=True))(p)
    p, o = opt.update(g, o, p)
    return p, o, loss
with set_mesh(mesh):
    jstep = jax.jit(step)
    rng = np.random.RandomState(0)
    losses = []
    for i in range(%d):
        x = jnp.asarray(rng.randint(0, cfg.vocab, (4, 16)), jnp.int32)
        params, ostate, loss = jstep(params, ostate, x, x)
        losses.append(float(loss))
print(json.dumps(losses))
""" % STEPS


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's 8-device losses and its initial parameters (numpy)."""
    import pickle

    path = tmp_path_factory.mktemp("ref") / "params.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX, str(path)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:
        params_np = pickle.load(f)
    return json.loads(out.stdout.strip().splitlines()[-1]), params_np


def _opt():
    from repro_torch.optim.adamw import AdamW

    return AdamW(lr=1e-3, weight_decay=0.0)


def _train_sharded(rank, params_np, batches):
    """One rank of the (2, 4) mesh: 8 sharded train steps; the losses and
    the final parameters gathered."""
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.dryrun import make_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M

    torch.set_num_threads(1)
    cfg = _train_cfg()
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    mi = SH.make_mesh_info(mesh)
    params = lm_params_from_jax(params_np, cfg, "cpu")
    opt = _opt()
    state = opt.init(params)
    pspecs = SH.param_pspecs(cfg, params, mi)
    params = convert.distribute(params, pspecs, mesh)
    state = convert.distribute(state, SH.opt_pspecs(pspecs, state), mesh)
    step = make_train_step(cfg, opt, par=M.ParallelCfg(dispatch_groups=mi.dp_size))
    losses = []
    for x in batches:
        t = torch.from_numpy(x)
        batch = {"inputs": t, "labels": t}
        batch = convert.distribute(batch, SH.batch_pspecs(cfg, batch, mi), mesh)
        params, state, loss = step(params, state, batch)
        losses.append(float(loss.to_local()))
    final = [t.detach().numpy() for t in M.distinct_leaves(convert.gather(params))]
    placed = [str(p.placements) for p in M.distinct_leaves(params)]
    return losses, final if rank == 0 else None, placed


def test_sharded_train_step_matches_unsharded_and_the_reference(reference):
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import model as M
    from repro_torch.runtime.train_loop import make_train_step

    ref_losses, params_np = reference
    cfg = _train_cfg()
    batches = _batches(cfg)
    ranks = spawn_local(8, _train_sharded, params_np, batches, timeout=600)
    losses, final, placed = ranks[0]
    assert all(r[0] == losses for r in ranks)  # the replicated loss, on every rank
    assert any("Shard" in p for p in placed)  # the parameters really are sharded

    params = lm_params_from_jax(params_np, cfg, "cpu")
    opt = _opt()
    state = opt.init(params)
    step = make_train_step(cfg, opt, device="cpu")
    want = []
    for x in batches:
        t = torch.from_numpy(x)
        params, state, loss = step(params, state, {"inputs": t, "labels": t})
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    for got, w in zip(final, M.distinct_leaves(params)):
        w = w.detach().numpy()
        assert float(np.abs(got - w).max()) <= 1e-4 * max(float(np.abs(w).max()), 1.0)


def _moe_grads(rank, seed):
    """One rank of the (2, 2) mesh: reduced mixtral's loss (aux included) and
    every gradient, sharded, gathered, beside the unsharded ones."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.runtime.train_loop import value_and_grad

    torch.set_num_threads(1)
    cfg = get_arch("mixtral-8x22b").reduced()
    params = M.init(torch.Generator().manual_seed(seed), cfg)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    mi = SH.make_mesh_info(mesh)
    x = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab, (B, S)))
    par = M.ParallelCfg(dispatch_groups=2)

    def loss_of(p, a, b):
        return M.loss_fn(p, cfg, a, b, par=par)

    want_loss, want = value_and_grad(params, loss_of, x, x)
    sharded = convert.distribute(M.map_tree(lambda t: t.detach().clone(), params),
                                 SH.param_pspecs(cfg, params, mi), mesh)
    batch = convert.distribute({"i": x, "l": x}, SH.batch_pspecs(cfg, {"i": x, "l": x}, mi),
                               mesh)
    with SH.mixing(batch["i"]):
        loss, got = value_and_grad(sharded, loss_of, batch["i"], batch["l"])
    return (float(loss.full_tensor()), float(want_loss),
            [g.full_tensor().numpy() for g in got], [g.numpy() for g in want])


def test_sharded_moe_gradients_match_unsharded():
    """The expert layer per data group (``moe._sharded_experts``): the loss
    with its balance term and every gradient, the router's through both the
    experts' output (a partial sum over model) and the balance statistics,
    against the unsharded port on (2 data, 2 model); f32, within 1e-5 of each
    gradient's largest magnitude (sums in other orders)."""
    loss, want_loss, got, want = spawn_local(4, _moe_grads, 5, timeout=600)[0]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for g, w in zip(got, want):
        assert float(np.abs(g - w).max()) <= 1e-5 * max(float(np.abs(w).max()), 1e-12)


# ---------------------------------------------------------------------------
# Prefill and decode on (2 data, 2 model)
# ---------------------------------------------------------------------------

SERVE = {
    "qwen3": lambda: get_arch("qwen3-0.6b").reduced(),
    "qwen3-kv1": lambda: dataclasses.replace(get_arch("qwen3-0.6b").reduced(),
                                             n_kv_heads=1),
    "qwen3-h3": lambda: dataclasses.replace(get_arch("qwen3-0.6b").reduced(),
                                            n_heads=3, n_kv_heads=1),
    "gemma2-kv1": lambda: dataclasses.replace(get_arch("gemma2-9b").reduced(), n_kv_heads=1,
                                              window=8),
    "mixtral": lambda: get_arch("mixtral-8x22b").reduced(),
    "zamba2": lambda: get_arch("zamba2-7b").reduced(),
    "rwkv6": lambda: get_arch("rwkv6-1.6b").reduced(),
}


def _serve(cfg, params, prompts, prefill, decode, caches, to_batch):
    """Greedy: the prefill's logits, then ``GEN`` decode steps'."""
    logits, caches = prefill(params, to_batch(prompts), caches)
    out = [logits]
    for i in range(GEN):
        tok = _full(logits).argmax(-1)[:, None]
        logits, caches = decode(params, to_batch(tok), caches, PROMPT + i)
        out.append(logits)
    return [_full(x).numpy() for x in out]


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _serve_sharded(rank, all_params):
    """One rank of the (2, 2) mesh: every config's logits and its "dh" calls."""
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import make_serve_steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M

    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    mi = SH.make_mesh_info(mesh)
    out = {}
    for name, params_np in all_params.items():
        cfg = SERVE[name]()
        params = lm_params_from_jax(params_np, cfg, "cpu")
        params = convert.distribute(params, SH.param_pspecs(cfg, params, mi), mesh)
        prefill, decode = make_serve_steps(cfg, mi, B, par=M.ParallelCfg(dispatch_groups=2))
        max_len = PROMPT + GEN + 1
        caches = convert.distribute(M.make_caches(cfg, B, max_len, "cpu"),
                               SH.cache_pspecs(cfg, B, max_len, mi, kind="prefill"), mesh)
        decode_specs = SH.cache_pspecs(cfg, B, max_len, mi)

        def to_batch(t):
            return convert.distribute({"t": t}, SH.batch_pspecs(cfg, {"t": t}, mi), mesh)["t"]

        def decode_in_layout(p, t, c, n):  # the prefill's caches resharded once
            return decode(p, t, SH.reshard(c, decode_specs), n)

        before = ops.attention.dh_plain_calls
        got = _serve(cfg, params, torch.from_numpy(_prompts(cfg)), prefill,
                     decode_in_layout, caches, to_batch)
        out[name] = (got, ops.attention.dh_plain_calls - before)
    return out


def _prompts(cfg):
    return np.random.RandomState(3).randint(0, cfg.vocab, (B, PROMPT)).astype(np.int64)


def _jax_params(name):
    import jax

    import repro.configs.base as JB
    from repro.models import model as JM

    cfg = SERVE[name]()
    jcfg = dataclasses.replace(JB.get_arch(cfg.name.removesuffix("-reduced")).reduced(),
                               n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    return jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(1), jcfg))


@pytest.fixture(scope="module")
def served():
    """Every config's weights (the reference's ``init``) and the 4 ranks'
    sharded logits, from one spawn."""
    all_params = {name: _jax_params(name) for name in SERVE}
    return all_params, spawn_local(4, _serve_sharded, all_params, timeout=600)


@pytest.mark.parametrize("name", sorted(SERVE))
def test_sharded_prefill_and_decode_match_unsharded(served, name):
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import model as M

    all_params, ranks = served
    cfg = SERVE[name]()
    got, dh_calls = ranks[0][name]
    params = lm_params_from_jax(all_params[name], cfg, "cpu")
    par = M.ParallelCfg(dispatch_groups=2)
    caches = M.make_caches(cfg, B, PROMPT + GEN + 1, "cpu")
    with torch.no_grad():
        want = _serve(cfg, params, torch.from_numpy(_prompts(cfg)),
                      lambda p, t, c: M.prefill(p, cfg, t, c, par=par),
                      lambda p, t, c, n: M.decode_step(p, cfg, t, c, n, par=par),
                      caches, lambda t: t)
    for r in ranks:
        for a, b in zip(r[name][0], got):
            np.testing.assert_array_equal(a, b)  # every rank the same logits
    for g, w in zip(got, want):
        assert float(np.abs(g - w).max()) <= 2e-4 * float(np.abs(w).max()) + 1e-5
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))
    if name in ("qwen3-kv1", "qwen3-h3", "gemma2-kv1"):
        assert dh_calls == GEN * cfg.layers_total  # every decode step's attention
    else:
        assert dh_calls == 0
