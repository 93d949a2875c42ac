"""Expectation-Maximization for Gaussian Mixtures (paper §3.1.4, Fig. 7).

The counterpart of ``repro/core/algorithms/gmm.py``.  Six MapReduce-family
operations per round, in the JAX package's order:

  1. densities  p_ik  (Eq. 2)  — ``foreach`` over points (elementwise map)
  6. log-likelihood  (Eq. 7)   — MapReduce, dense [1] "sum" (static key)
  2. membership w_ik  (Eq. 3)  — ``foreach``
  3. N_k = Σ_i w_ik            — MapReduce, dense [K] "sum"
  4. Σ_i w_ik x_i    (Eq. 5)   — MapReduce, dense [K, d] "sum"
  5. Σ_i w_ik (x−μ)(x−μ)ᵀ (Eq. 6) — MapReduce, dense [K, d, d] "sum"

Ops 3–5 emit ``arange(k)`` keys, which ``engine="pallas"`` routes through
the segment-reduce kernel.  Points live in one ``DistVector`` of rows
``[x | p-or-w]``.  In ``mode="per_op"`` the mixture's precisions and
normalisers are computed on the host in float64 (K is tiny) and cast to f32,
as in the JAX package.

``mode="program"`` plans a whole EM round (the two ``ctx.foreach`` maps,
whose per-point results stay on the shards, the four MapReduce ops and the
M-step glue) as one program, ``unroll`` rounds a dispatch
(``session.run_loop``; one CUDA graph replay on the card).  The
log-likelihood, N_k and Σwx sums share one collective, Σw(x−μ)(x−μ)ᵀ
(which needs the new means) runs alone: 2 collectives a round instead of 4.
The precisions and normalisers come from an f32 Cholesky factorisation on
the device (:func:`_spd_inv_logdet`) where JAX calls ``jnp.linalg``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import DistVector
from repro_torch.core.containers import Mesh
from repro_torch.core.session import BlazeSession, resolve


def _gauss_env(alpha, mu, sigma, device):
    """Per-component precision + normalisation (host, float64, then f32)."""
    k, d = mu.shape
    prec = np.linalg.inv(sigma)
    logdet = np.linalg.slogdet(sigma)[1]
    logcoef = -0.5 * (d * np.log(2 * np.pi) + logdet)
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in (alpha, mu, prec, logcoef))


def density_fn(row, env):
    """foreach #1: fill the p-block with Gaussian log-densities (Eq. 2)."""
    alpha, mu, prec, logcoef = env
    d = mu.shape[1]
    x = row[:d]
    diff = x[None, :] - mu  # [K, d]
    maha = torch.einsum("kd,kde,ke->k", diff, prec, diff)
    return torch.cat([x, logcoef - 0.5 * maha])


def membership_fn(row, env):
    """foreach #2: p-block → w-block (Eq. 3), through log-sum-exp."""
    alpha, mu, prec, logcoef = env
    d = mu.shape[1]
    x, logp = row[:d], row[d:]
    logw = logp + torch.log(torch.clamp(alpha, min=1e-30))
    logw = logw - torch.logsumexp(logw, dim=0)
    return torch.cat([x, torch.exp(logw)])


def nk_mapper(i, row, emit, mu):
    k = mu.shape[0]
    emit(torch.arange(k, device=row.device), row[-k:])


def musum_mapper(i, row, emit, mu):
    k, d = mu.shape
    x, w = row[:d], row[-k:]
    emit(torch.arange(k, device=row.device), w[:, None] * x[None, :])


def sigmasum_mapper(i, row, emit, mu):
    k, d = mu.shape
    x, w = row[:d], row[-k:]
    diff = x[None, :] - mu  # [K, d]
    outer = diff[:, :, None] * diff[:, None, :]
    emit(torch.arange(k, device=row.device), w[:, None, None] * outer)


def loglik_mapper(i, row, emit, alpha):
    k = alpha.shape[0]
    logp = row[-k:]
    emit(0, torch.logsumexp(logp + torch.log(torch.clamp(alpha, min=1e-30)), dim=0))


@dataclasses.dataclass
class GMMResult:
    alpha: np.ndarray
    mu: np.ndarray
    sigma: np.ndarray
    log_likelihood: float
    iterations: int
    converged: bool
    shuffle_bytes_per_iter: int
    compiles: int = 0  # shard stages built across ALL iterations
    program_compiles: int = 0  # program plans / graph captures (mode="program")
    dispatches: int = 0  # stage runs (or program blocks) across the loop
    host_syncs: int = 0  # blocking host materialisations across the loop
    collectives_per_iter: int = 0  # optimised plan's collectives (program mode)


def _spd_inv_logdet(sigma: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(inverse, log det)`` of each symmetric positive definite ``[d, d]``
    matrix of ``sigma [K, d, d]``, from a Cholesky factor ``L`` written out
    over the ``d`` columns (``d`` is small and static) with elementwise ops
    on the K matrices: ``log det = 2 Σ log L_jj`` and ``inv = L^-T L^-1``.
    Unlike ``torch.linalg.inv``, which checks its result on the host, it
    runs inside a captured CUDA graph."""
    d = sigma.shape[-1]
    low = [[None] * d for _ in range(d)]
    for j in range(d):
        low[j][j] = torch.sqrt(sigma[:, j, j] - sum(low[j][m] ** 2 for m in range(j)))
        for i in range(j + 1, d):
            low[i][j] = (sigma[:, i, j]
                         - sum(low[i][m] * low[j][m] for m in range(j))) / low[j][j]
    logdet = 2.0 * sum(torch.log(low[j][j]) for j in range(d))
    zero = torch.zeros_like(sigma[:, 0, 0])
    inv_low = [[zero] * d for _ in range(d)]  # L^-1, lower triangular
    for i in range(d):
        inv_low[i][i] = 1.0 / low[i][i]
        for j in range(i):
            inv_low[i][j] = -sum(low[i][m] * inv_low[m][j]
                                 for m in range(j, i)) / low[i][i]
    m = torch.stack([torch.stack(row, -1) for row in inv_low], -2)  # [K, d, d]
    return m.transpose(1, 2) @ m, logdet


def _program_step(rows_v, k: int, d: int, n: int, engine: str):
    """(step_fn, state builder) for the planned EM round: the
    log-likelihood, N_k and Σwx psums are independent f32 sums first
    consumed together at the M-step, so they batch into one collective;
    Σw(x−μ)(x−μ)ᵀ depends on the new means and ships alone (2 collectives
    a round, against 4 unbatched)."""
    dev = rows_v.data.device
    eye = torch.eye(d, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def step(ctx, s):
        alpha_, mu_, sigma_ = s["alpha"], s["mu"], s["sigma"]
        prec, logdet = _spd_inv_logdet(sigma_)
        logcoef = -0.5 * (d * math.log(2.0 * math.pi) + logdet)
        env = (alpha_, mu_, prec, logcoef)
        rows_p = ctx.foreach(rows_v, density_fn, env=env)  # op 1
        ll = ctx.map_reduce(rows_p, loglik_mapper, "sum", zeros(1),  # op 6
                            engine=engine, env=alpha_)[0]
        rows_w = ctx.foreach(rows_p, membership_fn, env=env)  # op 2
        nk = ctx.map_reduce(rows_w, nk_mapper, "sum", zeros(k),  # op 3
                            engine=engine, env=mu_)
        musum = ctx.map_reduce(rows_w, musum_mapper, "sum", zeros(k, d),  # op 4
                               engine=engine, env=mu_)
        nk_c = torch.clamp(nk, min=1e-8)  # first consumption: ll/nk/musum flush
        new_mu = musum / nk_c[:, None]
        sigsum = ctx.map_reduce(  # op 5: needs new_mu, its own collective
            rows_w, sigmasum_mapper, "sum", zeros(k, d, d), engine=engine,
            env=new_mu,
        )
        new_sigma = sigsum / nk_c[:, None, None] + 1e-4 * eye
        return {"alpha": nk_c / n, "mu": new_mu, "sigma": new_sigma,
                "ll": ll.reshape(()), "prev_ll": s["ll"]}

    def state0(alpha, mu, sigma):
        def dev_f32(a):
            # A tensor already on the device (the serving layer's, copied
            # without a host sync) is taken as it is.
            if isinstance(a, torch.Tensor):
                return a.to(dev, torch.float32)
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        return {"alpha": dev_f32(alpha), "mu": dev_f32(mu), "sigma": dev_f32(sigma),
                "ll": torch.full((), float("-inf"), device=dev),
                "prev_ll": torch.full((), float("-inf"), device=dev)}

    return step, state0


def gmm_em(
    points: np.ndarray,
    k: int,
    *,
    init_mu: np.ndarray | None = None,
    tol: float = 1e-4,
    max_iters: int = 50,
    engine: str = "eager",
    mode: str = "per_op",
    unroll: int = 1,
    seed: int = 0,
    mesh: Mesh | None = None,
    session: BlazeSession | None = None,
) -> GMMResult:
    if mode not in ("per_op", "program"):
        raise ValueError(f"unknown mode {mode!r}; choose 'per_op' or 'program'")
    sess, mesh = resolve(session, mesh)
    dev = mesh.device
    n, d = points.shape
    rng = np.random.RandomState(seed)
    if init_mu is None:
        init_mu = points[rng.choice(n, k, replace=False)]
    alpha = np.full(k, 1.0 / k, np.float32)
    mu = init_mu.astype(np.float32).copy()
    sigma = np.tile(np.eye(d, dtype=np.float32), (k, 1, 1))

    rows0 = np.concatenate([points, np.zeros((n, k), np.float32)], axis=1)
    rows_v: DistVector = sess.distribute(rows0.astype(np.float32), mesh=mesh)
    compiles0 = sess.stats.compiles
    dispatches0 = sess.stats.dispatches
    syncs0 = sess.stats.host_syncs

    if mode == "program":
        step, state0 = _program_step(rows_v, k, d, n, engine)

        def cond(s):
            ll_, prev = float(s["ll"]), float(s["prev_ll"])
            return abs(ll_ - prev) < tol * max(1.0, abs(prev))

        prog = sess.program(step, mesh=mesh)
        state, info = sess.run_loop(prog, state0(alpha, mu, sigma), cond=cond,
                                    max_iters=max_iters, unroll=unroll)
        return GMMResult(
            alpha=state["alpha"].cpu().numpy(),
            mu=state["mu"].cpu().numpy(),
            sigma=state["sigma"].cpu().numpy(),
            log_likelihood=float(state["ll"]),
            iterations=info.iterations,
            converged=info.converged,
            shuffle_bytes_per_iter=0,
            compiles=sess.stats.compiles - compiles0,
            program_compiles=info.compiles,
            dispatches=sess.stats.dispatches - dispatches0,
            host_syncs=sess.stats.host_syncs - syncs0,
            collectives_per_iter=prog.plan.collectives_per_iter,
        )

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    prev_ll, it, converged, stats, ll = -np.inf, 0, False, None, float("nan")
    for it in range(1, max_iters + 1):
        env = _gauss_env(alpha, mu, sigma, dev)
        rows_p = sess.foreach(rows_v, density_fn, env=env)  # op 1
        # op 6 (log-likelihood of the CURRENT model) reads the p-block:
        ll_t = sess.map_reduce(rows_p, loglik_mapper, "sum", zeros(1),
                               engine=engine, env=env[0], mesh=mesh)[0]
        rows_w = sess.foreach(rows_p, membership_fn, env=env)  # op 2
        nk = sess.map_reduce(rows_w, nk_mapper, "sum", zeros(k),  # op 3
                             engine=engine, env=env[1], mesh=mesh)
        musum, stats = sess.map_reduce(  # op 4
            rows_w, musum_mapper, "sum", zeros(k, d), engine=engine,
            env=env[1], return_stats=True, mesh=mesh,
        )
        nk_np = np.maximum(sess.host_value(nk), 1e-8)
        new_mu = sess.host_value(musum) / nk_np[:, None]
        sigsum = sess.map_reduce(  # op 5
            rows_w, sigmasum_mapper, "sum", zeros(k, d, d), engine=engine,
            env=torch.as_tensor(new_mu, device=dev), mesh=mesh,
        )
        alpha = (nk_np / n).astype(np.float32)
        mu = new_mu.astype(np.float32)
        sigma = (
            sess.host_value(sigsum) / nk_np[:, None, None]
            + 1e-4 * np.eye(d, dtype=np.float32)
        ).astype(np.float32)

        ll = float(sess.host_value(ll_t))
        if abs(ll - prev_ll) < tol * max(1.0, abs(prev_ll)):
            converged = True
            break
        prev_ll = ll

    fs = stats.finalize() if stats is not None else None
    return GMMResult(
        alpha=alpha, mu=mu, sigma=sigma, log_likelihood=ll,
        iterations=it, converged=converged,
        shuffle_bytes_per_iter=fs.shuffle_payload_bytes if fs else 0,
        compiles=sess.stats.compiles - compiles0,
        dispatches=sess.stats.dispatches - dispatches0,
        host_syncs=sess.stats.host_syncs - syncs0,
    )


def gmm_em_reference(points, k, init_mu, tol=1e-4, max_iters=50):
    """numpy oracle with the same update rules + regularisation."""
    n, d = points.shape
    alpha = np.full(k, 1.0 / k)
    mu = init_mu.astype(np.float64).copy()
    sigma = np.tile(np.eye(d), (k, 1, 1))
    prev_ll = -np.inf
    for it in range(1, max_iters + 1):
        prec = np.linalg.inv(sigma)
        logdet = np.linalg.slogdet(sigma)[1]
        diff = points[:, None, :] - mu[None]  # [n,k,d]
        maha = np.einsum("nkd,kde,nke->nk", diff, prec, diff)
        logp = -0.5 * (d * np.log(2 * np.pi) + logdet)[None] - 0.5 * maha
        logw = logp + np.log(alpha)[None]
        ll = np.log(np.exp(logw - logw.max(1, keepdims=True)).sum(1)).sum() + logw.max(1).sum()
        w = np.exp(logw - logw.max(1, keepdims=True))
        w /= w.sum(1, keepdims=True)
        nk = np.maximum(w.sum(0), 1e-8)
        new_mu = (w[:, :, None] * points[:, None, :]).sum(0) / nk[:, None]
        diff2 = points[:, None, :] - new_mu[None]
        sigma = (
            np.einsum("nk,nkd,nke->kde", w, diff2, diff2) / nk[:, None, None]
            + 1e-4 * np.eye(d)
        )
        alpha = nk / n
        mu = new_mu
        if abs(ll - prev_ll) < tol * max(1.0, abs(prev_ll)):
            break
        prev_ll = ll
    return alpha, mu, sigma, ll, it
