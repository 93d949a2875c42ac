"""The port's LM training path against the JAX package's: ``loss_fn`` with
remat, its gradients, ``remat_policy`` and ``scan_layers``, on the six
token-fed dense and recurrent architectures and mixtral-8x22b (MoE: the loss carries
``aux_coef · aux``, the balance loss's gradient too) at ``reduced()``
size, with the same weights (JAX's ``M.init`` carried across by
``convert.lm_params_from_jax``), and one AdamW step of mixtral.

Tolerances, stated per check:

* f32 (the reduced configs' dtype): both packages sum the same products in
  other orders (XLA's and PyTorch's CPU matmuls; the port's materialised
  attention against the reference's chunked one; the port's scans against
  the reference's), ~1e-6 relative an op.  The loss, a mean of O(1)
  log-likelihoods, agrees within ``rtol = 1e-5``.  A gradient leaf
  crosses every later layer and the backward, up to 18 layers (zamba2),
  where its rounding reached 5e-5 of the leaf's largest magnitude; each
  leaf is held within ``2e-4·max|g_ref| + 1e-7``.
* bf16 (qwen3-0.6b's reduced config in bf16): parameters and activations
  round to 8 bits, ``2^-8`` relative an op, which the two packages place
  differently; over 2 layers the loss agrees within ``rtol = 2e-2`` and
  each gradient leaf within ``0.1·max|g_ref|`` (the worst leaf reached
  3.1e-2 of it; a missing path through attention would be O(1) of it).
* Within the port, ``remat`` on and off, ``remat_policy="dots"`` and
  ``"full"``, and ``scan_layers`` True and False run the same operations on
  the same inputs: equal bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import model as JM
from repro.optim import adamw as JO
from repro.runtime import train_loop as JT
from repro_torch.configs.base import SHARED_ATTN, get_arch
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime import train_loop as T

ARCHS = ["gemma2-9b", "mixtral-8x22b", "qwen3-0.6b", "rwkv6-1.6b", "stablelm-3b",
         "starcoder2-15b", "zamba2-7b"]
CPU = torch.device("cpu")
B, S, CHUNK = 2, 24, 7  # CHUNK < S and does not divide it


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[rng.rand(B, S) < 0.2] = -1  # masked positions
    labels[0, -3:] = -1  # and a masked tail inside the last chunk
    return x, labels


def _setup(arch, dtype=None):
    cfg_j, cfg_t = jget_arch(arch).reduced(), get_arch(arch).reduced()
    if dtype is not None:
        cfg_j = dataclasses.replace(cfg_j, param_dtype=dtype, compute_dtype=dtype)
        cfg_t = dataclasses.replace(cfg_t, param_dtype=dtype, compute_dtype=dtype)
    params_j = JM.init(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(1)

    def perturb(path, x):  # norm scales off their init, so a misplaced 1+s shows
        x = np.asarray(x)
        if getattr(path[-1], "key", None) == "scale":
            return (x.astype(np.float32) + 0.1 * rng.randn(*x.shape)).astype(x.dtype)
        return x

    params_np = jax.tree_util.tree_map_with_path(perturb, params_j)
    return cfg_j, cfg_t, params_np


def _port_loss_and_grads(cfg, params_np, x, labels, **kw):
    params = lm_params_from_jax(params_np, cfg, CPU)
    leaves = M.distinct_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = M.loss_fn(params, cfg, torch.from_numpy(x), torch.from_numpy(labels),
                     loss_chunk=CHUNK, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(t) if g is None else g
                           for t, g in zip(leaves, grads)]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """The reference's loss and gradients (``remat=True``) and its loss with
    ``remat=False``, on one reduced arch in f32."""
    cfg_j, cfg_t, params_np = _setup(request.param)
    x, labels = _batch(cfg_j)

    def loss(p, remat):
        return JM.loss_fn(p, cfg_j, jnp.asarray(x), jnp.asarray(labels), remat=remat,
                          loss_chunk=CHUNK)

    p = jax.tree.map(jnp.asarray, params_np)
    loss_r, grads = jax.jit(jax.value_and_grad(lambda q: loss(q, True)))(p)
    grads_t = M.distinct_leaves(lm_params_from_jax(jax.tree.map(np.asarray, grads),
                                                   cfg_t, CPU))
    return dict(cfg=cfg_t, params_np=params_np, x=x, labels=labels, grads=grads_t,
                loss={True: float(loss_r), False: float(jax.jit(loss, static_argnums=1)(
                    p, False))})


@pytest.mark.parametrize("remat", [True, False])
def test_loss_matches_reference(ref, remat):
    got, _ = _port_loss_and_grads(ref["cfg"], ref["params_np"], ref["x"], ref["labels"],
                                  remat=remat)
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), ref["loss"][remat], rtol=1e-5)


def test_grads_match_reference(ref):
    """Mirrors ``tests/test_models.py::test_grad_finite``, held to
    ``jax.grad`` of the reference's ``loss_fn`` leaf by leaf."""
    _, grads = _port_loss_and_grads(ref["cfg"], ref["params_np"], ref["x"],
                                    ref["labels"], remat=True)
    assert len(grads) == len(ref["grads"])
    assert sum(float((g ** 2).sum()) for g in grads) > 0
    for g, w in zip(grads, ref["grads"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=2e-4 * float(w.abs().max()) + 1e-7)


def test_remat_on_off_and_policies_equal_bit_for_bit(ref):
    base = _port_loss_and_grads(ref["cfg"], ref["params_np"], ref["x"], ref["labels"],
                                remat=False)
    for kw in (dict(remat=True), dict(remat=True, remat_policy="dots")):
        loss, grads = _port_loss_and_grads(ref["cfg"], ref["params_np"], ref["x"],
                                           ref["labels"], **kw)
        assert torch.equal(loss, base[0])
        assert all(torch.equal(g, w) for g, w in zip(grads, base[1]))


def test_scan_vs_unroll_same_loss():
    """Mirrors ``tests/test_models.py::test_scan_vs_unroll_same_loss``; the
    port loops over layers either way, and holds the reference's unrolled
    loss too."""
    cfg_j, cfg_t, params_np = _setup("gemma2-9b")
    x, labels = _batch(cfg_t, seed=2)
    params = lm_params_from_jax(params_np, cfg_t, CPU)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    l1 = M.loss_fn(params, cfg_t, xt, lt, scan_layers=True, remat=False)
    l2 = M.loss_fn(params, cfg_t, xt, lt, scan_layers=False, remat=False)
    assert torch.equal(l1, l2)
    want = jax.jit(lambda p: JM.loss_fn(p, cfg_j, jnp.asarray(x), jnp.asarray(labels),
                                        scan_layers=False, remat=False))(
        jax.tree.map(jnp.asarray, params_np))
    np.testing.assert_allclose(float(l2), float(want), rtol=1e-5)


def test_bf16_loss_and_grads_near_reference():
    cfg_j, cfg_t, params_np = _setup("qwen3-0.6b", "bfloat16")
    x, labels = _batch(cfg_t, seed=3)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(
        p, cfg_j, jnp.asarray(x), jnp.asarray(labels), remat=True, loss_chunk=CHUNK)))(
        jax.tree.map(jnp.asarray, params_np))
    loss, grads = _port_loss_and_grads(cfg_t, params_np, x, labels, remat=True)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=2e-2)
    want = M.distinct_leaves(lm_params_from_jax(jax.tree.map(np.asarray, grads_j),
                                                cfg_t, CPU))
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float(), w.float()
        assert float((g - w).abs().max()) <= 0.1 * float(w.abs().max()) + 1e-6


def test_zamba2_shared_block_is_one_set_of_leaves():
    """Every ``SHARED_ATTN`` layer is ``params["shared_attn"]``; the tree's
    distinct leaves (what takes a gradient and an update) hold it once, as
    JAX's pytree does, and a tree mapped from it keeps the sharing."""
    cfg = get_arch("zamba2-7b").reduced()
    params = M.init(torch.Generator().manual_seed(0), cfg)
    shared = [i for i, k in enumerate(M.layer_kinds(cfg)) if k == SHARED_ATTN]
    assert len(shared) > 1 and all(params["layers"][i] is params["shared_attn"]
                                   for i in shared)
    leaves = M.distinct_leaves(params)
    assert sum(t.numel() for t in leaves) == M.param_count(params)
    jparams = JM.init(jax.random.PRNGKey(0), jget_arch("zamba2-7b").reduced())
    assert len(leaves) < sum(1 for _ in M._leaves(params))
    assert M.param_count(params) == JM.param_count(jparams)
    mapped = M.map_tree(torch.zeros_like, params)
    assert all(mapped["layers"][i] is mapped["shared_attn"] for i in shared)
    assert [t.shape for t in M.distinct_leaves(mapped)] == [t.shape for t in leaves]


def test_moe_adamw_step_matches_reference():
    """One training step of reduced mixtral (``make_train_step``: the loss
    with its aux term, the gradients, one AdamW update) from the reference's
    initial optimiser state carried across by ``opt_state_from_jax``.  As
    ``tests/test_torch_train_loop.py``'s step: ``weight_decay = 0`` (the
    reference decays its stacked 1-D leaves) and ``eps = 1e-4``, so a
    gradient's rounding ``δ`` moves a parameter by at most ``lr·δ/1e-4``:
    the parameters within ``1e-3·lr``; the moments ``(1 − b1)·g`` and
    ``(1 − b2)·g²`` within the gradients' bound above (twice it for the
    square)."""
    cfg_j, cfg_t, params_np = _setup("mixtral-8x22b")
    x, labels = _batch(cfg_t, seed=4)
    batch = {"inputs": x, "labels": labels}
    lr = 1e-3
    opt_j = JO.AdamW(lr=lr, weight_decay=0.0, eps=1e-4)
    pj = jax.tree.map(jnp.asarray, params_np)
    state_j = opt_j.init(pj)
    pj, state_j1, loss_j = jax.jit(JT.make_train_step(cfg_j, opt_j))(
        pj, state_j, jax.tree.map(jnp.asarray, batch))
    params = lm_params_from_jax(params_np, cfg_t, CPU)
    state = opt_state_from_jax(jax.tree.map(np.asarray, state_j), cfg_t, CPU)
    assert all("moe" in layer and set(layer["moe"]) == {"router", "w_gate", "w_up", "w_down"}
               for layer in state["m"]["layers"])
    opt_t = AdamW(lr=lr, weight_decay=0.0, eps=1e-4)
    params, state, loss = T.make_train_step(cfg_t, opt_t, device="cpu")(
        params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want = lm_params_from_jax(jax.tree.map(np.asarray, pj), cfg_t, CPU)
    for got, w in zip(M.distinct_leaves(params), M.distinct_leaves(want)):
        np.testing.assert_allclose(got.detach().numpy(), w.numpy(), rtol=0, atol=1e-3 * lr)
    want = opt_state_from_jax(jax.tree.map(np.asarray, state_j1), cfg_t, CPU)
    assert int(state["step"]) == int(want["step"]) == 1
    for key, factor in (("m", 1), ("v", 2)):
        for got, w in zip(M.distinct_leaves(state[key]), M.distinct_leaves(want[key])):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                       atol=factor * 2e-4 * float(w.abs().max()) + 1e-12)
