"""Expectation-Maximization for Gaussian Mixtures (paper §3.1.4, Fig. 7).

The counterpart of ``repro/core/algorithms/gmm.py``, per-op mode.  Six
MapReduce-family operations per round, in the JAX package's order:

  1. densities  p_ik  (Eq. 2)  — ``foreach`` over points (elementwise map)
  6. log-likelihood  (Eq. 7)   — MapReduce, dense [1] "sum" (static key)
  2. membership w_ik  (Eq. 3)  — ``foreach``
  3. N_k = Σ_i w_ik            — MapReduce, dense [K] "sum"
  4. Σ_i w_ik x_i    (Eq. 5)   — MapReduce, dense [K, d] "sum"
  5. Σ_i w_ik (x−μ)(x−μ)ᵀ (Eq. 6) — MapReduce, dense [K, d, d] "sum"

Ops 3–5 emit ``arange(k)`` keys, which ``engine="pallas"`` routes through
the segment-reduce kernel.  Points live in one ``DistVector`` of rows
``[x | p-or-w]``.  The mixture's precisions and normalisers are computed on
the host in float64 (K is tiny) and cast to f32, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import DistVector
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
    dispatches: int = 0  # stage runs across the loop
    host_syncs: int = 0  # blocking host materialisations across the loop


def gmm_em(
    points: np.ndarray,
    k: int,
    *,
    init_mu: np.ndarray | None = None,
    tol: float = 1e-4,
    max_iters: int = 50,
    engine: str = "eager",
    mode: str = "per_op",
    seed: int = 0,
    session: BlazeSession | None = None,
) -> GMMResult:
    if mode != "per_op":
        raise NotImplementedError(
            f"mode={mode!r} comes with the fused-program slice of the port; "
            "use mode='per_op'"
        )
    sess = resolve(session)
    dev = sess.device
    n, d = points.shape
    rng = np.random.RandomState(seed)
    if init_mu is None:
        init_mu = points[rng.choice(n, k, replace=False)]
    alpha = np.full(k, 1.0 / k, np.float32)
    mu = init_mu.astype(np.float32).copy()
    sigma = np.tile(np.eye(d, dtype=np.float32), (k, 1, 1))

    rows0 = np.concatenate([points, np.zeros((n, k), np.float32)], axis=1)
    rows_v: DistVector = sess.distribute(rows0.astype(np.float32))
    compiles0 = sess.stats.compiles
    dispatches0 = sess.stats.dispatches
    syncs0 = sess.stats.host_syncs

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    prev_ll, it, converged, stats, ll = -np.inf, 0, False, None, float("nan")
    for it in range(1, max_iters + 1):
        env = _gauss_env(alpha, mu, sigma, dev)
        rows_p = sess.foreach(rows_v, density_fn, env=env)  # op 1
        # op 6 (log-likelihood of the CURRENT model) reads the p-block:
        ll_t = sess.map_reduce(rows_p, loglik_mapper, "sum", zeros(1),
                               engine=engine, env=env[0])[0]
        rows_w = sess.foreach(rows_p, membership_fn, env=env)  # op 2
        nk = sess.map_reduce(rows_w, nk_mapper, "sum", zeros(k),  # op 3
                             engine=engine, env=env[1])
        musum, stats = sess.map_reduce(  # op 4
            rows_w, musum_mapper, "sum", zeros(k, d), engine=engine,
            env=env[1], return_stats=True,
        )
        nk_np = np.maximum(sess.host_value(nk), 1e-8)
        new_mu = sess.host_value(musum) / nk_np[:, None]
        sigsum = sess.map_reduce(  # op 5
            rows_w, sigmasum_mapper, "sum", zeros(k, d, d), engine=engine,
            env=torch.as_tensor(new_mu, device=dev),
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
