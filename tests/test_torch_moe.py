"""The port's MoE layer (``repro_torch.models.moe``) and M-RoPE
(``models.layers.apply_mrope``, the attention block and ``forward`` with
``(t, h, w)`` positions) against the JAX package's, at ``reduced()`` size in
f32, with the same weights (JAX's ``M.init`` carried across by
``convert.lm_params_from_jax``).

Tolerances: both packages compute the router's logits, the softmax and the
expert products in f32, summing the same products in other orders (XLA's
and PyTorch's CPU matmuls), ~1e-6 relative an op over O(1) values, so
outputs and the aux loss agree within ``atol = rtol = 1e-4``.  Routes are
compared for equality: the inputs are drawn so that no token's k-th and
(k+1)-th router probabilities lie within 1e-5 of each other (checked),
far above that rounding, so both packages must pick the same experts, and
with tied router columns both must pick the lower index.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.configs.base import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=["mixtral-8x22b", "grok-1-314b"])
def moe(request):
    """``(jax cfg, port cfg, layer 0's moe params as numpy)`` of one reduced
    MoE arch."""
    cfg_j = jget_arch(request.param).reduced()
    params = JM.init(jax.random.PRNGKey(0), cfg_j)
    layer0 = jax.tree.map(lambda a: np.asarray(a[0]), params["stages"]["slot0"]["moe"])
    return cfg_j, get_arch(request.param).reduced(), layer0


def _x(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randn(b, s, cfg.d_model).astype(np.float32)


def _both(cfg_j, cfg_t, params_np, x, **kw):
    """``(reference out, aux, top_e)`` and the port's, plus the port's routes."""
    pj = jax.tree.map(jnp.asarray, params_np)
    out_j, aux_j = JMOE.moe_apply(pj, cfg_j, jnp.asarray(x), **kw)
    g = kw.get("dispatch_groups", 1)
    g = g if (x.shape[0] * x.shape[1]) % g == 0 and x.shape[0] % g == 0 else 1
    logits = jnp.asarray(x).reshape(g, -1, x.shape[-1]) @ pj["router"]
    top_j = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg_j.top_k)[1]
    pt = {k: torch.from_numpy(np.array(v)) for k, v in params_np.items()}
    out_t, aux_t = MOE.moe_apply(pt, cfg_t, torch.from_numpy(x), **kw)
    r = MOE.routes(pt, cfg_t, torch.from_numpy(x), **kw)
    return (np.asarray(out_j), float(aux_j), np.asarray(top_j)), (out_t, float(aux_t), r)


def _gap(r, k):
    """Each token's gap between its k-th and (k+1)-th router probability."""
    p = torch.sort(r["probs"], dim=-1, descending=True).values
    return p[..., k - 1] - p[..., k]


def _naive(params_np, cfg, x, r):
    """``Σ_j w_j · FFN_{e_j}(x_t)`` over each token's kept choices, a token
    at a time in float64: what the dispatch and combine must compute."""
    p = {k: torch.from_numpy(np.array(v)).double() for k, v in params_np.items()}
    xt = torch.from_numpy(x).double().reshape(r["top_e"].shape[0], -1, x.shape[-1])
    out = torch.zeros_like(xt)
    for g in range(xt.shape[0]):
        for t in range(xt.shape[1]):
            probs = r["probs"][g, t].double()
            chosen = r["top_e"][g, t]
            w = probs[chosen] / probs[chosen].sum()
            for j, e in enumerate(chosen.tolist()):
                if r["kept"][g, t, j]:
                    h = torch.nn.functional.silu(xt[g, t] @ p["w_gate"][e])
                    out[g, t] += w[j] * ((h * (xt[g, t] @ p["w_up"][e])) @ p["w_down"][e])
    return out.reshape(x.shape)


def test_moe_apply_matches_reference(moe):
    """Output, aux and routes on 2 × 12 tokens; nothing drops at the reduced
    capacity factor (8.0), so the port also equals the naive sum."""
    cfg_j, cfg_t, params_np = moe
    x = _x(cfg_t, 2, 12)
    (out_j, aux_j, top_j), (out_t, aux_t, r) = _both(cfg_j, cfg_t, params_np, x)
    assert float(_gap(r, cfg_t.top_k).min()) > 1e-5
    np.testing.assert_array_equal(r["top_e"].numpy(), top_j)
    assert bool(r["kept"].all())
    np.testing.assert_allclose(out_t.numpy(), out_j, **TOL)
    np.testing.assert_allclose(aux_t, aux_j, **TOL)
    np.testing.assert_allclose(out_t.numpy(), _naive(params_np, cfg_t, x, r).numpy(),
                               **TOL)


def test_moe_capacity_drops_like_the_reference(moe):
    """The published capacity factor (1.25) on 4 × 16 tokens, with the router
    pulled towards expert 0: its capacity (40 of the 64 tokens' choices)
    overflows, later tokens' choices drop, and the port's output, dropped
    tokens included, equals the reference's and the naive sum over the kept
    choices."""
    cfg_j, cfg_t, params_np = moe
    cfg_j = dataclasses.replace(cfg_j, capacity_factor=1.25)
    cfg_t = dataclasses.replace(cfg_t, capacity_factor=1.25)
    params_np = dict(params_np)
    router = params_np["router"].copy()
    router[:, 0] += 0.2
    params_np["router"] = router
    x = _x(cfg_t, 4, 16, seed=1) + 0.5
    (out_j, aux_j, top_j), (out_t, aux_t, r) = _both(cfg_j, cfg_t, params_np, x)
    assert r["cap"] == 40
    assert float(_gap(r, cfg_t.top_k).min()) > 1e-5
    np.testing.assert_array_equal(r["top_e"].numpy(), top_j)
    dropped = ~r["kept"]
    assert int(dropped.sum()) > 0 and int((r["top_e"][dropped] == 0).sum()) == int(
        dropped.sum())
    # the first 40 choices of expert 0, in token order, are kept
    flat_e, flat_k = r["top_e"].reshape(-1), r["kept"].reshape(-1)
    assert bool(flat_k[flat_e == 0][:40].all()) and not bool(flat_k[flat_e == 0][40:].any())
    np.testing.assert_allclose(out_t.numpy(), out_j, **TOL)
    np.testing.assert_allclose(aux_t, aux_j, **TOL)
    np.testing.assert_allclose(out_t.numpy(), _naive(params_np, cfg_t, x, r).numpy(),
                               **TOL)


def test_moe_tied_router_columns_pick_the_lower_expert(moe):
    """Columns 1 = 0 and 3 = 2 of the router: every token's probabilities tie
    in pairs, and top-2 takes a tied pair lower index first (as
    ``lax.top_k``)."""
    cfg_j, cfg_t, params_np = moe
    params_np = dict(params_np)
    router = params_np["router"].copy()
    router[:, 1], router[:, 3] = router[:, 0], router[:, 2]
    params_np["router"] = router
    x = _x(cfg_t, 2, 12, seed=2)
    (out_j, _, top_j), (out_t, _, r) = _both(cfg_j, cfg_t, params_np, x)
    assert bool((r["probs"][..., 0] == r["probs"][..., 1]).all())
    np.testing.assert_array_equal(r["top_e"].numpy(), top_j)
    assert set(map(tuple, r["top_e"].reshape(-1, 2).tolist())) <= {(0, 1), (2, 3)}
    np.testing.assert_allclose(out_t.numpy(), out_j, **TOL)


def test_moe_dispatch_groups(moe):
    """Mirrors ``tests/test_models.py::test_moe_dispatch_group_invariance``:
    ``forward`` with 1 and 2 dispatch groups agree (nothing drops), and the
    2-group layer matches the reference's; 3 groups do not divide the batch
    of 2 and fall back to 1."""
    cfg_j, cfg_t, params_np = moe
    x = _x(cfg_t, 2, 12, seed=3)
    (out_j, aux_j, _), (out_t, aux_t, r) = _both(cfg_j, cfg_t, params_np, x,
                                                 dispatch_groups=2)
    assert r["probs"].shape[0] == 2
    np.testing.assert_allclose(out_t.numpy(), out_j, **TOL)
    np.testing.assert_allclose(aux_t, aux_j, **TOL)
    assert MOE.routes({k: torch.from_numpy(np.array(v)) for k, v in params_np.items()}, cfg_t,
                      torch.from_numpy(x), dispatch_groups=3)["probs"].shape[0] == 1
    params = M.init(torch.Generator().manual_seed(0), cfg_t)
    tokens = torch.from_numpy(np.random.RandomState(4).randint(0, cfg_t.vocab, (2, 12)))
    h1, _, a1 = M.forward(params, cfg_t, tokens, par=M.ParallelCfg(dispatch_groups=1))
    h2, _, a2 = M.forward(params, cfg_t, tokens, par=M.ParallelCfg(dispatch_groups=2))
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=1e-5)
    assert float(a1) > 0 and float(a2) > 0


def test_forward_sums_the_aux_of_every_layer(moe):
    """``forward``'s aux is the sum of its MoE layers' (the reference's), with
    and without remat; ``active_param_count`` is the reference's."""
    cfg_j, cfg_t, _ = moe
    params_j = JM.init(jax.random.PRNGKey(0), cfg_j)
    params_t = lm_params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, CPU)
    tokens = np.random.RandomState(5).randint(0, cfg_t.vocab, (2, 12)).astype(np.int32)
    _, _, aux_j = JM.forward(params_j, cfg_j, jnp.asarray(tokens))
    for remat in (False, True):
        with torch.enable_grad():
            _, _, aux_t = M.forward(params_t, cfg_t, torch.from_numpy(tokens), remat=remat)
        np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)
    assert M.active_param_count(params_t, cfg_t) == JM.active_param_count(params_j, cfg_j)
    assert M.active_param_count(params_t, cfg_t) < M.param_count(params_t)


@pytest.mark.parametrize("sections,d", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_apply_mrope_matches_reference(sections, d):
    """Distinct ``(t, h, w)`` triples: each section of rotary pairs turns by
    its own coordinate; the reduced (2, 3, 3) and qwen2-vl-2b's published
    (16, 24, 24) sections."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, d).astype(np.float32)
    pos = rng.randint(0, 4096, (3, 2, 5)).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections, 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # text positions: all three coordinates equal is plain RoPE
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    np.testing.assert_allclose(
        L.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), sections, 1e6).numpy(),
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]), 1e6).numpy(),
        atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="sum to D/2"):
        L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (1, 1, 1))


@pytest.fixture(scope="module")
def qwen2_vl():
    cfg_j = jget_arch("qwen2-vl-2b").reduced()
    params_j = JM.init(jax.random.PRNGKey(0), cfg_j)
    cfg_t = get_arch("qwen2-vl-2b").reduced()
    return cfg_j, params_j, cfg_t, lm_params_from_jax(jax.tree.map(np.asarray, params_j),
                                                      cfg_t, CPU)


def _triples(b, s, seed):
    """Vision-like positions: t fixed, (h, w) over a grid, then text."""
    rng = np.random.RandomState(seed)
    pos = np.zeros((3, b, s), np.int32)
    for i in range(b):
        t0 = rng.randint(0, 5)
        pos[0, i] = t0 + np.arange(s) // 6
        pos[1, i] = t0 + np.arange(s) % 6 // 3
        pos[2, i] = t0 + np.arange(s) % 3
    return pos


def test_mrope_attention_block_matches_reference(qwen2_vl):
    """One qwen2-vl attention block at distinct ``(t, h, w)`` triples, then
    written into a cache and one more step at its own triple."""
    cfg_j, params_j, cfg_t, params_t = qwen2_vl
    x = _x(cfg_t, 2, 6, seed=6)
    pos = _triples(2, 6, seed=0)
    pj = jax.tree.map(lambda a: a[0], params_j["stages"]["slot0"]["attn"])
    pt = params_t["layers"][0]["attn"]
    want, _ = JA.attn_apply(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos))
    got, _ = A.attn_apply(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cj, ct = JA.make_cache(cfg_j, 2, 8), A.make_cache(cfg_t, 2, 8, CPU)
    _, cj = JA.attn_apply(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos), cache=cj,
                          cache_len=0)
    A.attn_apply(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(pos), cache=ct,
                 cache_len=0)
    x1, p1 = _x(cfg_t, 2, 1, seed=7), np.full((3, 2, 1), 9, np.int32)
    p1[1] = 3
    want, _ = JA.attn_apply(pj, cfg_j, jnp.asarray(x1), jnp.asarray(p1), cache=cj,
                            cache_len=6)
    got, _ = A.attn_apply(pt, cfg_t, torch.from_numpy(x1), torch.from_numpy(p1),
                          cache=ct, cache_len=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mrope_forward_with_positions_matches_reference(qwen2_vl):
    """``forward(positions=[3, B, S])`` on embeddings, and the default
    positions (text: ``[3, B, S]`` of ``arange``) equal to passing them."""
    cfg_j, params_j, cfg_t, params_t = qwen2_vl
    x = _x(cfg_t, 2, 12, seed=8)
    pos = _triples(2, 12, seed=1)
    want, _, _ = JM.forward(params_j, cfg_j, jnp.asarray(x), positions=jnp.asarray(pos))
    got, _, _ = M.forward(params_t, cfg_t, torch.from_numpy(x),
                          positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    text = torch.arange(12).expand(3, 2, 12)
    assert torch.equal(M.forward(params_t, cfg_t, torch.from_numpy(x))[0],
                       M.forward(params_t, cfg_t, torch.from_numpy(x), positions=text)[0])
    with pytest.raises(ValueError, match="takes embeddings"):
        M.forward(params_t, cfg_t, torch.zeros((2, 12), dtype=torch.long))


def test_reference_leaves_group_moe_tensors_by_stage_slot():
    """``reference_leaves`` (``dp_train``'s int8 framing) groups each MoE
    tensor with the same tensor of every stage, as the reference stacks
    ``router [n_stages, d, E]`` and ``w_* [n_stages, E, ·, ·]``: the groups'
    stacked shapes are the reference pytree's leaf shapes."""
    cfg_j, cfg_t = jget_arch("mixtral-8x22b").reduced(), get_arch("mixtral-8x22b").reduced()
    params_j = JM.init(jax.random.PRNGKey(0), cfg_j)
    params_t = lm_params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, CPU)
    groups = M.reference_leaves(params_t, cfg_t)
    got = sorted((len(g), *g[0].shape) if len(g) > 1 else tuple(g[0].shape) for g in groups)
    assert got == sorted(tuple(x.shape) for x in jax.tree.leaves(params_j))
    assert (cfg_t.n_stages, cfg_t.n_experts, cfg_t.d_model, cfg_t.d_ff) in got


def _trace(probs, k=2):
    top_e = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :k]
    return {"probs": probs, "top_e": top_e, "kept": torch.ones(top_e.shape, dtype=torch.bool)}


def test_compare_routes_tells_near_tie_flips_from_others():
    """``chip_smoke.compare_routes`` (the card's route check): two runs'
    router probabilities 1e-4 apart; a flip at a near-tie (gap 1e-5) is
    allowed and taints its row from its position on, at later layers and in
    the logits; a flip where the gap is 0.2 is reported, and so is a kept
    choice that differs with no flip before it in its call."""
    import chip_smoke

    g = torch.Generator().manual_seed(0)
    probs = [torch.softmax(torch.randn(2, 4, 4, generator=g), -1) for _ in range(2)]
    noisy = [p + 1e-4 * torch.rand(p.shape, generator=g) for p in probs]
    a = [_trace(p) for p in probs]
    cmp = chip_smoke.compare_routes(a, [_trace(p) for p in noisy], [4], 2)
    assert cmp["flips"] == 0 and bool(cmp["clean"].all()) and 0 < cmp["delta_max"] < 2e-4
    # a near-tie at layer 0, row 0, position 1: experts 1 and 2 swap
    tie_a, tie_b = probs[0].clone(), noisy[0].clone()
    tie_a[0, 1] = torch.tensor([0.4, 0.25, 0.249995, 0.100005])
    tie_b[0, 1] = torch.tensor([0.4, 0.249995, 0.25, 0.100005])
    a = [_trace(tie_a), _trace(probs[1])]
    cmp = chip_smoke.compare_routes(a, [_trace(tie_b), _trace(noisy[1])], [4], 2)
    assert cmp["flips"] == cmp["checked_flips"] == 1 and not cmp["not_near_tie"]
    assert cmp["clean"].tolist() == [[True, False, False, False], [True] * 4]
    # a flip away from any tie, at layer 1, row 1
    far_b = noisy[1].clone()
    far_b[1, 2] = far_b[1, 2].flip(0)
    cmp = chip_smoke.compare_routes(a, [_trace(tie_b), _trace(far_b)], [4], 2)
    assert cmp["flips"] == 2 and len(cmp["not_near_tie"]) == 1
    assert cmp["not_near_tie"][0]["layer"] == 1
    # a kept choice that differs with no flip before it
    dropped = _trace(noisy[1])
    dropped["kept"][0, 0, 1] = False
    cmp = chip_smoke.compare_routes([_trace(probs[0]), _trace(probs[1])],
                                    [_trace(noisy[0]), dropped], [4], 2)
    assert cmp["unexplained_knock_on"][0]["layer"] == 1


def test_apply_mrope_sizes_nothing_from_data():
    """``apply_mrope`` takes its sections from the Python tuple: on meta
    tensors (no data) it runs, so on the card it copies nothing to the
    device and waits on nothing, as ``apply_rope`` does."""
    x = torch.empty(2, 5, 3, 128, device="meta")
    pos = torch.empty(3, 2, 5, dtype=torch.int64, device="meta")
    assert L.apply_mrope(x, pos, (16, 24, 24), 1e6).shape == x.shape


@pytest.mark.parametrize("arch", ["grok-1-314b", "qwen2-vl-2b", "musicgen-medium"])
def test_decode_weight_bytes_counts_the_embedding_rows_a_step_reads(arch):
    """``chip_smoke.decode_weight_bytes``: every weight once, but of an
    untied embedding table the ``B`` rows a step gathers (grok), none when a
    frontend feeds the embeddings (musicgen); a tied table is the head and
    is read whole (qwen2-vl)."""
    import chip_smoke

    cfg = get_arch(arch).reduced()
    params = M.init(torch.Generator().manual_seed(0), cfg)
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    total = sum(nbytes(t) for t in M._leaves(params))
    table, row = nbytes(params["embed"]), nbytes(params["embed"][0])
    want = {"grok-1-314b": total - table + 8 * row, "qwen2-vl-2b": total,
            "musicgen-medium": total - table}[arch]
    assert chip_smoke.decode_weight_bytes(params, cfg, 8) == want


def test_routes_checked_needs_its_share_of_clean_logits():
    """``Smoke.routes_checked``: a near-tie flip at the prompt's first
    position taints every logit of its row; a pair passes only while its
    clean share reaches the share asked for, and a pair without logits holds
    the routes alone."""
    import chip_smoke

    smoke = object.__new__(chip_smoke.Smoke)
    smoke.torch, smoke.dev = torch, torch.device("cpu")
    g = torch.Generator().manual_seed(0)
    probs = torch.softmax(torch.randn(2, 4, 4, generator=g), -1)
    tie_a, tie_b = probs.clone(), probs.clone()
    tie_a[0, 0] = torch.tensor([0.4, 0.25, 0.249995, 0.100005])
    tie_b[0, 0] = torch.tensor([0.4, 0.249995, 0.25, 0.100005])
    tie_b[1] += 1e-5 * torch.rand(tie_b[1].shape, generator=g)
    logs = []
    for p in (tie_a, tie_b):
        log = chip_smoke.RouteLog()
        log.calls = [_trace(p)]
        logs.append(log)
    logits = torch.randn(2, 2, 8, generator=g)  # positions 2 and 3 of a 3-token prompt
    near = logits + 1e-3
    out = smoke.routes_checked("t", {"p": (logits, logs[0], near, logs[1], [4], 0.5)},
                               1, 2, 3, 1e-2)
    assert out["p"]["clean_logits"] == 2 and out["p"]["of"] == 4
    with pytest.raises(AssertionError, match="logits clean"):
        smoke.routes_checked("t", {"p": (logits, logs[0], near, logs[1], [4], 0.75)},
                             1, 2, 3, 1e-2)
    with pytest.raises(AssertionError, match="logits clean"):
        smoke.routes_checked("t", {"p": (logits, logs[0], logits + 1.0, logs[1], [4], 0.5)},
                             1, 2, 3, 1e-2)
    out = smoke.routes_checked("t", {"p": (None, logs[0], None, logs[1], [4], 0.0)},
                               1, 2, 3, 1e-2)
    assert out["p"]["flips"] == 1 and "logit_err" not in out["p"]
