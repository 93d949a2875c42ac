"""Local multi-process runs: ``P`` processes on one machine, one node row each.

The counterpart of ``repro/launch/simulate.py``.  The reference simulates a
multi-host topology inside one process by forcing XLA's host-device count;
that flag has no meaning for PyTorch.  The port's topology across processes
is real processes instead: this module starts ``P`` of them on this machine
and brings up a ``torch.distributed`` group among them, so
``launch.mesh.make_node_data_mesh()`` gives each its node row.

* ``spawn_local(P, fn, *args, backend=, device=, timeout=)`` runs
  ``fn(rank, *args)`` in each of ``P`` fresh processes (``spawn``: ``fn``
  and ``args`` must pickle, so ``fn`` is a module-level function) and
  returns each rank's result, rank 0's first.  A rank that raises, dies or
  outlives ``timeout`` fails the call with that rank's stderr; every
  process is stopped before it returns or raises, so it never hangs its
  caller.
* ``local_env(rank, P)`` is the worker recipe: the environment a rank runs
  in (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` as ``torchrun`` sets them).

The group rendezvous through a ``torch.distributed.FileStore`` in a fresh
temporary directory, not a TCP port, so concurrent runs (test workers under
``pytest-xdist``) never collide.  The backend defaults to ``gloo`` on the
CPU and ``nccl`` on the card (rank ``r`` on card ``r``; NCCL refuses two
ranks on one card).
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

__all__ = ["local_env", "spawn_local"]

#: The stderr tail a failure reports, per rank.
_ERR_TAIL = 6000


def local_env(rank: int, n_procs: int, base_env=None) -> dict:
    """The environment of rank ``rank`` of ``n_procs`` local processes:
    ``base_env`` (default ``os.environ``) with ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` set, as ``torchrun`` sets them."""
    if not 0 <= rank < n_procs:
        raise ValueError(f"rank {rank} is not in [0, {n_procs})")
    env = dict(os.environ if base_env is None else base_env)
    env.update(RANK=str(rank), WORLD_SIZE=str(n_procs), LOCAL_RANK=str(rank))
    return env


def _worker(rank, n_procs, store_path, backend, device, timeout, fn, args, out_path,
            err_path):
    """One rank: stderr to ``err_path``, the group up over the file store,
    ``fn(rank, *args)`` pickled to ``out_path``; exit code 1 on any error."""
    err = os.open(err_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(err, 2)
    import sys

    sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)
    code = 0
    try:
        os.environ.update(local_env(rank, n_procs, base_env={}))
        import torch
        import torch.distributed as dist

        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n_procs), world_size=n_procs,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        with open(out_path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out_path + ".tmp", out_path)
    except BaseException:  # noqa: BLE001 - reported through stderr and the exit code
        traceback.print_exc()
        code = 1
    sys.stderr.flush()
    os._exit(code)


def _tail(path: str) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-_ERR_TAIL:]
    except OSError:
        return ""


def spawn_local(n_procs: int, fn, *args, backend: str | None = None,
                device: str = "cpu", timeout: float = 120.0) -> list:
    """Run ``fn(rank, *args)`` in ``n_procs`` fresh local processes joined
    in one process group; returns ``[result of rank 0, ..., rank P-1]``.

    ``backend`` defaults to ``"gloo"`` for ``device="cpu"`` and ``"nccl"``
    for ``"cuda"``.  ``timeout`` (seconds) bounds the whole run and each
    collective.  ``RuntimeError`` when a rank raises or dies (every failed
    rank named with its stderr: the peers of a rank that died fail in their
    next collective) or when the run outlives
    ``timeout`` (the ranks still running named, with their stderr); the
    processes are stopped either way.
    """
    import multiprocessing as mp

    if n_procs < 1:
        raise ValueError(f"n_procs must be >= 1, got {n_procs}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    tmp = tempfile.mkdtemp(prefix="blaze_spawn_")
    store = os.path.join(tmp, "store")
    outs = [os.path.join(tmp, f"out{r}.pkl") for r in range(n_procs)]
    errs = [os.path.join(tmp, f"err{r}.txt") for r in range(n_procs)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, n_procs, store, backend, device, timeout, fn, args,
                               outs[r], errs[r]))
             for r in range(n_procs)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = []
        while time.monotonic() < deadline:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            time.sleep(0.02)
        if failed:
            # the peers of a rank that died fail in their next collective:
            # give them a moment, then report every failed rank
            time.sleep(0.5)
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            raise RuntimeError("\n".join(
                f"rank {r} of {n_procs} failed (exit code {procs[r].exitcode}); its "
                f"stderr:\n{_tail(errs[r])}" for r in failed))
        running = [r for r, p in enumerate(procs) if p.exitcode is None]
        if running:
            detail = "\n".join(f"-- rank {r}:\n{_tail(errs[r])}" for r in running)
            raise RuntimeError(
                f"ranks {running} of {n_procs} still ran after {timeout} s; their "
                f"stderr:\n{detail}")
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=5)
        shutil.rmtree(tmp, ignore_errors=True)
