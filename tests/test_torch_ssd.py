"""K5 (Mamba-2 SSD) and the Mamba-2 block of the port against the JAX
package's, on the same numpy inputs.

The port's ``ssd_scan`` wrapper takes its plain version, ``ssd_scan_plain``
(the port of ``ops.ssd_chunked``), on CPU tensors; JAX's Pallas kernel runs
in interpret mode, as its own tests run it (``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the CUDA kernel against the plain version
on the card).

Tolerances, as the JAX package's own SSD tests: everything is f32, and the
chunked form and the step-by-step recurrence sum the same terms in other
orders over up to 100 steps of O(1) values, so outputs and states agree
within ``atol = 3e-5`` (``2e-5`` against ``ops.ssd_chunked``, which shares
the decomposition; JAX's test uses the same bounds).  The Mamba-2 block,
whose projections and norm add a few f32 roundings of O(1) values, is held
to ``atol = rtol = 1e-4``, the bound of ``tests/test_torch_models.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro_torch.configs.base import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models import ssm as SSM

CPU = torch.device("cpu")


def _inputs(seed, B=2, S=96, H=4, P=8, G=2, N=16, dt_scale=0.3, init=False):
    """``tests/test_kernels.py``'s SSD inputs: ``t(shape, scale=0.5)``."""
    rng = np.random.RandomState(seed)

    def t(shape, scale=0.5):
        return (rng.randn(*shape) * scale).astype(np.float32)

    x = t((B, S, H, P))
    dt = np.abs(t((B, S, H), dt_scale)) + 0.01
    a = -np.abs(t((H,), 2.0)) - 0.1
    b, c = t((B, S, G, N)), t((B, S, G, N))
    h0 = t((B, H, P, N)) if init else None
    return x, dt, a, b, c, h0


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _t(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_plain_matches_the_pallas_kernel(chunk):
    """``tests/test_kernels.py::test_ssd_pallas_vs_ref``'s case: the TPU
    kernel in interpret mode against the port's wrapper on the CPU."""
    x, dt, a, b, c, _ = _inputs(0)
    yj, hj = jssd_scan(*_j(x, dt, a, b, c), chunk=chunk)
    y, h = ssd_scan(*_t(x, dt, a, b, c), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=3e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=3e-5)


@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_plain_matches_jax_chunked_and_ref(chunk, with_init):
    x, dt, a, b, c, h0 = _inputs(1, S=100, init=with_init)
    yj, hj = jops.ssd_chunked(*_j(x, dt, a, b, c), init_state=_j(h0)[0], chunk=chunk)
    y, h = ssd_scan_plain(*_t(x, dt, a, b, c), init_state=_t(h0)[0], chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=2e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=2e-5)
    yr, hr = JR.ssd_ref(*_j(x, dt, a, b, c), init_state=_j(h0)[0])
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=3e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=3e-5)


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_ref_matches_jax_ref(with_init):
    x, dt, a, b, c, h0 = _inputs(2, S=40, init=with_init)
    yj, hj = JR.ssd_ref(*_j(x, dt, a, b, c), init_state=_j(h0)[0])
    y, h = R.ssd_ref(*_t(x, dt, a, b, c), init_state=_t(h0)[0])
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=1e-5)
    # f64 inputs give the f64 oracle, within f32 rounding of the f32 one
    y64, h64 = R.ssd_ref(*[None if t is None else t.double()
                           for t in _t(x, dt, a, b, c, h0)[:5]],
                         init_state=None if h0 is None else torch.from_numpy(h0).double())
    assert y64.dtype == h64.dtype == torch.float64
    np.testing.assert_allclose(y64.numpy(), y.numpy(), atol=1e-5)


def test_ssd_extreme_decay_no_nan():
    """The inf·0 upper-triangle hazard (``tests/test_kernels.py:239``)."""
    x, dt, _, b, c, _ = _inputs(3, B=1, S=64, H=2, P=4, G=1, N=8, dt_scale=2.0)
    dt = dt + 1.0  # large steps
    a = np.asarray([-16.0, -8.0], np.float32)
    y, h = ssd_scan(*_t(x, dt, a, b, c), chunk=16)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    yj, hj = jops.ssd_chunked(*_j(x, dt, a, b, c), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=2e-5)


def test_ssd_decode_chaining_equals_full_scan():
    """Prefill then per-token steps, each from the last state, written in
    place, equal one full pass (``tests/test_kernels.py:264``)."""
    x, dt, a, b, c, _ = _inputs(4, B=1, S=48, H=2, P=4, G=1, N=8, dt_scale=0.2)
    x, dt, a, b, c = _t(x, dt, a, b, c)
    y_full, h_full = R.ssd_ref(x, dt, a, b, c)
    state = torch.zeros_like(h_full)
    ys = [ssd_scan(x[:, :32], dt[:, :32], a, b[:, :32], c[:, :32], chunk=16,
                   out_state=state)[0]]
    for i in range(32, 48):
        sl = slice(i, i + 1)
        y, h = ops.ssd(x[:, sl], dt[:, sl], a, b[:, sl], c[:, sl], init_state=state,
                       out_state=state, chunk=16)
        assert h is state
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(), atol=3e-5)
    np.testing.assert_allclose(state.numpy(), h_full.numpy(), atol=3e-5)


def test_ssd_ops_impls_agree_and_refuse_unknown():
    x, dt, a, b, c, h0 = _inputs(5, S=33, init=True)
    args = _t(x, dt, a, b, c)
    want = ssd_scan_plain(*args, init_state=torch.from_numpy(h0), chunk=16)
    for impl in ("auto", "pallas", "chunked"):
        y, h = ops.ssd(*args, init_state=torch.from_numpy(h0), chunk=16, impl=impl)
        assert torch.equal(y, want[0]) and torch.equal(h, want[1]), impl
    y, h = ops.ssd(*args, init_state=torch.from_numpy(h0), impl="ref")
    np.testing.assert_allclose(y.numpy(), want[0].numpy(), atol=3e-5)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.ssd(*args, impl="triton")
    with pytest.raises(ValueError, match="multiple of G"):
        ssd_scan(args[0], args[1], args[2], args[3][:, :, :1].expand(-1, -1, 3, -1),
                 args[4][:, :, :1].expand(-1, -1, 3, -1))


def test_mamba_block_matches_jax():
    """One Mamba-2 mixer with carried weights (a_log, dt_bias, d_skip and the
    norm perturbed off their init), without and with a cache: a 12-token
    prefill, then two decode steps from the cache the port wrote in place."""
    cfg_j = jget_arch("zamba2-7b").reduced()
    cfg_t = get_arch("zamba2-7b").reduced()
    params_np = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), cfg_j))
    rng = np.random.RandomState(6)
    pj = jax.tree.map(lambda a: np.asarray(a[0]), params_np["stages"]["slot0"]["mamba"])
    for key in ("a_log", "dt_bias", "d_skip"):
        pj[key] = (pj[key] + 0.3 * rng.randn(*pj[key].shape)).astype(np.float32)
    pj["norm"]["scale"] = (0.1 * rng.randn(*pj["norm"]["scale"].shape)).astype(np.float32)
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pj)
    pj = jax.tree.map(jnp.asarray, pj)
    x = rng.randn(2, 14, cfg_t.d_model).astype(np.float32)
    want, _ = JSSM.mamba_apply(pj, cfg_j, jnp.asarray(x))
    got, none = SSM.mamba_apply(pt, cfg_t, torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    cj, ct = JSSM.make_mamba_cache(cfg_j, 2), SSM.make_mamba_cache(cfg_t, 2, CPU)
    for lo, hi in ((0, 12), (12, 13), (13, 14)):
        want, cj = JSSM.mamba_apply(pj, cfg_j, jnp.asarray(x[:, lo:hi]), cache=cj)
        got, ct2 = SSM.mamba_apply(pt, cfg_t, torch.from_numpy(x[:, lo:hi]), cache=ct)
        assert ct2 is ct
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(ct.conv.numpy(), np.asarray(cj.conv), atol=1e-4)
        np.testing.assert_allclose(ct.h.numpy(), np.asarray(cj.h), atol=1e-4, rtol=1e-4)


def test_mamba_dims_at_full_width():
    """zamba2-7b's SSM: d_inner 7168, 112 heads, conv_dim 7424, d_proj 14704."""
    cfg = get_arch("zamba2-7b")
    d_inner, heads, conv_dim = SSM._dims(cfg)
    assert (d_inner, heads, conv_dim) == (7168, 112, 7424)
    assert 2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + heads == 14704
    cache = SSM.make_mamba_cache(cfg, 8, torch.device("meta"))
    assert cache.conv.shape == (8, 3, 7424) and cache.conv.dtype == torch.bfloat16
    assert cache.h.shape == (8, 112, 64, 64) and cache.h.dtype == torch.float32


def test_ssd_kernel_form_follows_the_step_count():
    from repro_torch.kernels.ssd_scan import form

    assert [form(s) for s in (1, 2, 64, 512)] == ["decode", "prefill", "prefill", "prefill"]


# The prefill form's arithmetic in plain PyTorch (csrc/ssd_scan.cu): the
# card's kernel takes its products on the tensor cores with every f32 operand
# split into bf16 parts.
SPLIT_CHUNK = 64  # the prefill form's chunk length


def split_bf16(v: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """``v`` f32 as ``parts`` bf16 values held in f32, each the bf16 of what
    the earlier ones left: two parts leave at most ``2^-18·|v|``, three
    ``2^-27·|v|``; an exactly bf16 ``v`` has every part after the first 0."""
    out = []
    for _ in range(parts):
        out.append(v.to(torch.bfloat16).float())
        v = v - out[-1]
    return out


def split_einsum(eq: str, u: torch.Tensor, v: torch.Tensor, parts: int) -> torch.Tensor:
    """``einsum(eq, u, v)`` as the prefill form takes it on the tensor cores:
    each operand in ``parts`` parts (``split_bf16``), the products of
    part pairs ``(i, j)`` with ``i + j < parts``, the smaller terms first."""
    us, vs = split_bf16(u.float(), parts), split_bf16(v.float(), parts)
    out = None
    for order in range(parts - 1, -1, -1):
        for i in range(order + 1):
            term = torch.einsum(eq, us[i], vs[order - i])
            out = term if out is None else out + term
    return out


def ssd_scan_split(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, init_state: torch.Tensor | None = None,
                   parts: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The prefill form's arithmetic in plain PyTorch: 64-step chunks, the
    running sum of ``a·dt`` in order, and every product through
    ``split_einsum``, in two parts for bf16 ``x`` (whose ``x``, ``B``,
    ``C`` are exact) and three for f32 (``C·Bᵀ``; ``y = exp(Δ_l)·C·hᵀ + M'·x``
    with ``M' = (C·Bᵀ)∘decay·dt``; ``h' = exp(T)·h + xᵀ·W`` with ``W =
    exp(T − Δ_s)·dt_s·B_s``); ``parts`` overrides the count.  Returns
    ``(y`` f32``, h_T)``."""
    bsz, s, h, p = x.shape
    rep = h // b.shape[2]
    if parts is None:
        parts = 2 if x.dtype == torch.bfloat16 else 3
    f32 = torch.float32
    bs = b.float().repeat_interleave(rep, dim=2)
    cs = c.float().repeat_interleave(rep, dim=2)
    state = (torch.zeros((bsz, h, p, b.shape[3]), dtype=f32, device=x.device)
             if init_state is None else init_state.float().clone())
    ys = []
    for c0 in range(0, s, SPLIT_CHUNK):
        sl = slice(c0, c0 + SPLIT_CHUNK)
        xc, dtc, bc, cc = x[:, sl].float(), dt[:, sl].float(), bs[:, sl], cs[:, sl]
        cum = torch.cumsum(a.float() * dtc, dim=1)  # Δ [B, L, H], in order
        total = cum[:, -1]
        cum_h = cum.transpose(1, 2)  # [B, H, L]
        diff = torch.clamp_max(cum_h[..., :, None] - cum_h[..., None, :], 0.0)
        live = torch.tril(torch.ones(diff.shape[-2:], dtype=torch.bool, device=x.device))
        m = torch.where(live, split_einsum("blhn,bshn->bhls", cc, bc, parts)
                        * torch.exp(diff) * dtc.transpose(1, 2)[:, :, None, :], 0.0)
        y = split_einsum("blhn,bhpn->blhp", cc, state, parts) * torch.exp(cum)[..., None]
        ys.append(y + split_einsum("bhls,bshp->blhp", m, xc, parts))
        w = bc * (torch.exp(total[:, None] - cum) * dtc)[..., None]
        state = state * torch.exp(total)[..., None, None] + split_einsum(
            "bshp,bshn->bhpn", xc, w, parts)
    return torch.cat(ys, 1), state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_split_products_match_jax_and_stay_in_the_bound(dtype):
    """The prefill form's arithmetic (``ssd_scan_split``: 64-step chunks,
    every f32 operand split into bf16 parts, two for the bf16 model whose x,
    B, C are exact, three for the f32 model) against JAX's Pallas kernel in
    interpret mode (``atol 3e-5``, as above) and against the float64 oracle
    within ``chip_smoke.ssd_bound``'s ``1.1·bound``.  The same arithmetic
    with one bf16 part per operand must leave the bound."""
    import chip_smoke

    x, dt, a, b, c, h0 = _inputs(7, S=128, H=4, P=16, G=2, N=32, init=True)
    # The bf16 model's x, B, C are bf16 values; JAX gets the same values in f32.
    x, b, c = (torch.from_numpy(t).to(dtype) for t in (x, b, c))
    xf, bf, cf = (t.float().numpy() for t in (x, b, c))
    yj, hj = jssd_scan(*_j(xf, dt, a, bf, cf), chunk=64)
    dt_t, a_t = torch.from_numpy(dt), torch.from_numpy(a)
    y, h = ssd_scan_split(x, dt_t, a_t, b, c)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=3e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=3e-5)
    f64 = [torch.from_numpy(t).double() for t in (xf, dt, a, bf, cf, h0)]
    y_ref, h_ref = R.ssd_ref(*f64[:5], init_state=f64[5])
    bound, tau = chip_smoke.ssd_bound(*f64, 128)
    assert tau > chip_smoke.ssd_tc_tau(32)

    def within(got):
        return all(bool(((g.double() - w).abs() <= 1.1 * bd).all())
                   for g, w, bd in zip(got, (y_ref, h_ref), bound))

    init = torch.from_numpy(h0)
    assert within(ssd_scan_split(x, dt_t, a_t, b, c, init_state=init))
    assert not within(ssd_scan_split(x, dt_t, a_t, b, c, init_state=init, parts=1))
