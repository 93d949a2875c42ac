"""K6 (RWKV-6 wkv) and the RWKV-6 block of the port against the JAX
package's, on the same numpy inputs.

The port's ``rwkv6_scan`` wrapper takes its plain version,
``rwkv6_scan_plain`` (the port of ``ops.rwkv6_chunked``), on CPU tensors;
JAX's Pallas kernel runs in interpret mode, as its own tests run it
(``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the CUDA kernel
against the plain version on the card).

Tolerances, as the JAX package's own RWKV-6 tests: everything is f32, the
chunked form and the step-by-step recurrence sum the same terms in other
orders over up to 70 steps of O(1) values, and the factored ``exp(±λ)``
scores lose a little more than the SSD's pairwise decay, so outputs and
states agree within ``atol = 5e-5``.  Where the ``−88 / L`` decay floor
bites, the chunked forms compute another function than the floorless
``rwkv6_ref``; that case is held against ``ops.rwkv6_chunked`` only, which
floors alike, within ``2e-5``.  The blocks, whose projections and norms add
a few f32 roundings, are held to ``atol = rtol = 1e-4``, the bound of
``tests/test_torch_models.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.kernels.rwkv6_scan import rwkv6_scan as jrwkv6_scan
from repro.models import model as JM
from repro.models import rwkv as JRW
from repro_torch.configs.base import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels.rwkv6_scan import decay_floor, rwkv6_scan, rwkv6_scan_plain
from repro_torch.models import rwkv as RW

CPU = torch.device("cpu")
BLOCK_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, B=2, S=70, H=2, K=8, V=8, init=False, w_lo=0.15):
    """``tests/test_kernels.py``'s RWKV-6 inputs: ``w = sigmoid(t)·0.8 +
    w_lo``."""
    rng = np.random.RandomState(seed)

    def t(shape):
        return (rng.randn(*shape) * 0.5).astype(np.float32)

    r, k, v = t((B, S, H, K)), t((B, S, H, K)), t((B, S, H, V))
    w = (1.0 / (1.0 + np.exp(-t((B, S, H, K)))) * 0.8 + w_lo).astype(np.float32)
    u = t((H, K))
    s0 = t((B, H, K, V)) if init else None
    return r, k, v, w, u, s0


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _t(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("chunk", [16, 32])
def test_rwkv6_plain_matches_the_pallas_kernel(chunk):
    """``tests/test_kernels.py::test_rwkv6_pallas_vs_ref``'s case: the TPU
    kernel in interpret mode against the port's wrapper on the CPU."""
    r, k, v, w, u, _ = _inputs(0, S=64)
    yj, sj = jrwkv6_scan(*_j(r, k, v, w, u), chunk=chunk)
    y, s = rwkv6_scan(*_t(r, k, v, w, u), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=5e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=5e-5)


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("with_init", [False, True])
def test_rwkv6_plain_matches_jax_chunked_and_ref(chunk, with_init):
    r, k, v, w, u, s0 = _inputs(1, init=with_init)
    yj, sj = jops.rwkv6_chunked(*_j(r, k, v, w, u), init_state=_j(s0)[0], chunk=chunk)
    y, s = rwkv6_scan_plain(*_t(r, k, v, w, u), init_state=_t(s0)[0], chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=2e-5)
    yr, sr = JR.rwkv6_ref(*_j(r, k, v, w, u), init_state=_j(s0)[0])
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=5e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), atol=5e-5)


@pytest.mark.parametrize("with_init", [False, True])
def test_rwkv6_ref_matches_jax_ref(with_init):
    r, k, v, w, u, s0 = _inputs(2, S=30, init=with_init)
    yj, sj = JR.rwkv6_ref(*_j(r, k, v, w, u), init_state=_j(s0)[0])
    y, s = R.rwkv6_ref(*_t(r, k, v, w, u), init_state=_t(s0)[0])
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-5)


def test_rwkv6_decay_floor_bites_at_chunk_64():
    """Decays down to e^-5 < e^(−88/64): the floor clamps them at chunk 64
    (prefill) but not at L = 1 (a decode step), as in the reference."""
    r, k, v, w, u, _ = _inputs(3, S=80, w_lo=0.0)
    w = np.exp(-5.0 * np.random.RandomState(4).rand(*w.shape)).astype(np.float32)
    assert (np.log(w) < decay_floor(64, 80)).mean() > 0.5
    yj, sj = jops.rwkv6_chunked(*_j(r, k, v, w, u), chunk=64)
    y, s = rwkv6_scan(*_t(r, k, v, w, u), chunk=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=2e-5)
    # The floor changes the function: the floorless oracle is far off here.
    yr, _ = JR.rwkv6_ref(*_j(r, k, v, w, u))
    assert np.abs(y.numpy() - np.asarray(yr)).max() > 1e-2
    # One step (L = 1, floor −88) matches the floorless oracle.
    y1, s1 = rwkv6_scan(*_t(r[:, :1], k[:, :1], v[:, :1], w[:, :1], u), chunk=64)
    yr1, sr1 = JR.rwkv6_ref(*_j(r[:, :1], k[:, :1], v[:, :1], w[:, :1], u))
    np.testing.assert_allclose(y1.numpy(), np.asarray(yr1), atol=1e-6)
    assert decay_floor(64, 1) == -88.0 and decay_floor(64, 512) == -88.0 / 64


def test_rwkv6_decode_chaining_equals_full_scan():
    """Prefill then per-token steps, each from the last state, written in
    place, equal one full pass (``tests/test_kernels.py:264``)."""
    r, k, v, w, u, _ = _inputs(5, B=1, S=48)
    r, k, v, w, u = _t(r, k, v, w, u)
    y_full, s_full = R.rwkv6_ref(r, k, v, w, u)
    state = torch.zeros_like(s_full)
    ys = [rwkv6_scan(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u, chunk=16,
                     out_state=state)[0]]
    for i in range(32, 48):
        sl = slice(i, i + 1)
        y, st = ops.rwkv6(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, init_state=state,
                          out_state=state, chunk=16)
        assert st is state
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(), atol=5e-5)
    np.testing.assert_allclose(state.numpy(), s_full.numpy(), atol=5e-5)


def test_rwkv6_ops_impls_agree_and_refuse_unknown():
    r, k, v, w, u, s0 = _inputs(6, S=21, init=True)
    args = _t(r, k, v, w, u)
    want = rwkv6_scan_plain(*args, init_state=torch.from_numpy(s0))
    for impl in ("auto", "pallas", "chunked"):
        y, s = ops.rwkv6(*args, init_state=torch.from_numpy(s0), impl=impl)
        assert torch.equal(y, want[0]) and torch.equal(s, want[1]), impl
    y, _ = ops.rwkv6(*args, init_state=torch.from_numpy(s0), impl="ref")
    np.testing.assert_allclose(y.numpy(), want[0].numpy(), atol=5e-5)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.rwkv6(*args, impl="triton")
    with pytest.raises(ValueError, match="u \\[H, K\\]"):
        rwkv6_scan(*args[:4], args[4][:1])


@pytest.fixture(scope="module")
def rwkv_params():
    """``(jax cfg, port cfg, layer-0 rwkv params as numpy)`` of reduced
    rwkv6, the norm scales and mixes perturbed off their zero init."""
    cfg_j = jget_arch("rwkv6-1.6b").reduced()
    params = JM.init(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(7)

    def layer0(path, a):
        a = np.array(a[0])
        name = getattr(path[-1], "key", "")
        if name in ("scale", "mix_base", "mix_k", "mix_r"):
            a = (a + 0.2 * rng.randn(*a.shape)).astype(a.dtype)
        return a

    p_np = jax.tree_util.tree_map_with_path(layer0, params["stages"]["slot0"]["rwkv"])
    return cfg_j, get_arch("rwkv6-1.6b").reduced(), p_np


def test_rwkv_time_and_channel_mix_match_jax(rwkv_params):
    """Time-mix and channel-mix with carried weights, without a cache, then
    with one: a 10-token prefill and two decode steps, the port's state
    written in place into its cache."""
    cfg_j, cfg_t, p_np = rwkv_params
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = jax.tree.map(torch.from_numpy, p_np)
    x = np.random.RandomState(8).randn(2, 12, cfg_t.d_model).astype(np.float32)
    want, shj, sj = JRW.time_mix(pj["tm"], cfg_j, jnp.asarray(x), None)
    got, sht, st = RW.time_mix(pt["tm"], cfg_t, torch.from_numpy(x), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **BLOCK_TOL)
    want, _ = JRW.channel_mix(pj["cm"], cfg_j, jnp.asarray(x), None)
    got, _ = RW.channel_mix(pt["cm"], cfg_t, torch.from_numpy(x), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)

    cj, ct = JRW.make_rwkv_cache(cfg_j, 2), RW.make_rwkv_cache(cfg_t, 2, CPU)
    for lo, hi in ((0, 10), (10, 11), (11, 12)):
        xj, xt = jnp.asarray(x[:, lo:hi]), torch.from_numpy(x[:, lo:hi])
        want, shj, sj = JRW.time_mix(pj["tm"], cfg_j, xj, cj)
        got, sht, st = RW.time_mix(pt["tm"], cfg_t, xt, ct)
        assert st is ct.state
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), **BLOCK_TOL)
        wcm, scj = JRW.channel_mix(pj["cm"], cfg_j, xj, cj)
        gcm, sct = RW.channel_mix(pt["cm"], cfg_t, xt, ct)
        np.testing.assert_allclose(gcm.numpy(), np.asarray(wcm), **BLOCK_TOL)
        cj = JRW.RWKVCache(shj, scj, sj)
        ct.shift_tm.copy_(sht)
        ct.shift_cm.copy_(sct)


def test_rwkv_cache_at_full_width():
    """rwkv6-1.6b's cache: two shift rows [B, 2048] bf16, the state [B, 32,
    64, 64] f32."""
    cache = RW.make_rwkv_cache(get_arch("rwkv6-1.6b"), 8, torch.device("meta"))
    assert cache.shift_tm.shape == cache.shift_cm.shape == (8, 2048)
    assert cache.shift_tm.dtype == torch.bfloat16
    assert cache.state.shape == (8, 32, 64, 64) and cache.state.dtype == torch.float32


def test_rwkv6_kernel_form_follows_the_step_count():
    from repro_torch.kernels.rwkv6_scan import FORMS, form

    assert FORMS == ("decode", "prefill")
    assert [form(s) for s in (1, 2, 64, 512)] == ["decode", "prefill", "prefill", "prefill"]


def rwkv6_scan_split(r, k, v, w, u, *, init_state=None, chunk=64, parts=None):
    """The prefill form's arithmetic in plain PyTorch (``csrc/rwkv6_scan.cu``):
    chunks of ``min(64, chunk, S)`` steps, the floored ``log w`` summed into
    ``λ``, the factors taken about ``λ_T/2`` (``A = r ∘ e^{λ_{l−1} − λ_T/2}``,
    ``B = k ∘ e^{λ_T/2 − λ_s}``), and every product through
    ``split_einsum`` (``tests/test_torch_ssd.py``), in two parts for bf16
    ``r, k, v`` (``v`` exact) and three for f32; ``parts`` overrides the
    count.  ``y = A·(e^{λ_T/2} ∘ S) + strict(A·Bᵀ)·v + diag ∘ v``, ``S' =
    e^{λ_T} ∘ S + e^{λ_T/2} ∘ (Bᵀ·v)``.  Returns ``(y`` f32``, S_T)``."""
    from test_torch_ssd import split_einsum

    bsz, s, h, kd = r.shape
    if parts is None:
        parts = 2 if r.dtype == torch.bfloat16 else 3
    L = min(64, chunk, s)
    floor = decay_floor(chunk, s)
    state = (torch.zeros((bsz, h, kd, v.shape[-1])) if init_state is None
             else init_state.float().clone())
    ys = []
    for c0 in range(0, s, L):
        sl = slice(c0, c0 + L)
        rc, kc, vc = r[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        logw = torch.clamp_min(torch.log(torch.clamp_min(w[:, sl].float(), 1e-30)), floor)
        lam = torch.cumsum(logw, dim=1)  # [B, l, H, K]
        prev = torch.cat([torch.zeros_like(lam[:, :1]), lam[:, :-1]], 1)
        half = 0.5 * lam[:, -1]  # [B, H, K]
        a = rc * torch.exp(prev - half[:, None])
        b = kc * torch.exp(half[:, None] - lam)
        n = rc.shape[1]
        strict = torch.tril(torch.ones((n, n)), diagonal=-1)
        scores = split_einsum("blhk,bshk->bhls", a, b, parts) * strict
        y = split_einsum("blhk,bhkv->blhv", a, state * torch.exp(half)[..., None], parts)
        y = y + split_einsum("bhls,bshv->blhv", scores, vc, parts)
        y = y + torch.einsum("blhk,blhk->blh", rc * u.float(), kc)[..., None] * vc
        state = (state * torch.exp(lam[:, -1])[..., None]
                 + torch.exp(half)[..., None] * split_einsum("bshk,bshv->bhkv", b, vc, parts))
        ys.append(y)
    return torch.cat(ys, 1), state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_split_products_match_jax_and_stay_in_the_bound(dtype):
    """The prefill form's arithmetic (``rwkv6_scan_split``) against JAX's
    Pallas kernel in interpret mode (``atol 5e-5``, as above) and against the
    float64 oracle on the floored decay within ``chip_smoke.rwkv6_bound``'s
    ``1.1·bound``, whose ``τ`` carries ``rwkv6_tc_tau``; with one bf16 part
    per operand it must leave the bound."""
    import chip_smoke

    r, k, v, w, u, s0 = _inputs(9, S=128, H=2, K=16, V=16, init=True)
    # The bf16 model's r, k, v are bf16 values; JAX gets the same values in f32.
    r, k, v = (torch.from_numpy(t).to(dtype) for t in (r, k, v))
    rf, kf, vf = (t.float().numpy() for t in (r, k, v))
    yj, sj = jrwkv6_scan(*_j(rf, kf, vf, w, u), chunk=64)
    w_t, u_t = torch.from_numpy(w), torch.from_numpy(u)
    y, st = rwkv6_scan_split(r, k, v, w_t, u_t)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=5e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=5e-5)
    init = torch.from_numpy(s0)
    f64 = [torch.from_numpy(t).double() for t in (rf, kf, vf, w, u, s0)]
    bound, tau, logw = chip_smoke.rwkv6_bound(*f64)
    assert bool((tau > chip_smoke.rwkv6_tc_tau(16)).all())
    y_ref, s_ref = R.rwkv6_ref(*f64[:3], torch.exp(logw), f64[4], init_state=f64[5])

    def within(got):
        return all(bool(((g.double() - want).abs() <= 1.1 * bd).all())
                   for g, want, bd in zip(got, (y_ref, s_ref), bound))

    assert within(rwkv6_scan_split(r, k, v, w_t, u_t, init_state=init))
    assert not within(rwkv6_scan_split(r, k, v, w_t, u_t, init_state=init, parts=1))


def test_rwkv6_split_products_at_the_floor():
    """Decays down to e^-5, below the floor of a 64-step chunk, so λ reaches
    −88 within a chunk: the factors about λ_T/2 stay within e^{±44}, and the
    split arithmetic stays within the bound of the floored oracle."""
    import chip_smoke

    r, k, v, w, u, s0 = _inputs(10, S=128, H=2, K=16, V=16, init=True)
    w = np.exp(-5.0 * np.random.RandomState(11).rand(*w.shape)).astype(np.float32)
    t = _t(r, k, v, w, u, s0)
    bound, tau, logw = chip_smoke.rwkv6_bound(*(x.double() for x in t))
    assert float(chip_smoke.window_decay(logw, 64).max()) > 80  # λ_T nears −88
    f64 = [x.double() for x in t]
    want = R.rwkv6_ref(*f64[:3], torch.exp(logw), f64[4], init_state=f64[5])
    got = rwkv6_scan_split(*t[:5], init_state=t[5])
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for g, ref, bd in zip(got, want, bound):
        assert bool(((g.double() - ref).abs() <= 1.1 * bd).all())
