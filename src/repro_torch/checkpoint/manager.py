"""Crash-safe checkpoints: atomic commit, keep-N, async save, restore.

The counterpart of ``repro/checkpoint/manager.py``.  A checkpoint stores the
logical arrays of a tree of tensors as numpy (``arrays.npz``) and a manifest
of the tree's structure, shapes and dtypes; restore puts them back onto the
structure and dtypes of a given tree, on its devices or on the placements
asked for.  The arrays are logical (a stacked-shard container's leading dim
does not depend on the mesh's node split), so a checkpoint restores bit for
bit onto any topology: elastic restore.  The format is the port's own: it
does not read the JAX package's checkpoints.

Atomicity: write ``step_N.tmp-<nonce>/``, then commit with a rename-aside
swap, ``rename(final, final.old-<nonce>)``; ``rename(tmp, final)``;
``rmtree(old)``, so at every crash point a complete checkpoint of the step
exists on disk (the old one until the new one is in place).  ``_recover``
rolls an interrupted swap back (``.old-`` to final) on start-up and restore;
``restore_latest`` skips unfinished ``.tmp-`` and ``.old-`` directories and
retries when an async save's ``_gc`` sweeps the step it picked.

Across processes (``save``/``restore`` with ``mesh=``, a mesh that carries a
``torch.distributed`` group, and ``per_rank=``, which marks the leaves each
rank holds its own rows of: a program's carry) the reference's stated
protocol, which it collapses to one process: each rank writes its rows of
the per-rank leaves into the step's ``tmp-`` directory
(``rank_<r>.npz``); rank 0 writes the replicated leaves (``arrays.npz``)
and the manifest, which holds each leaf's logical shape and the rows of
every rank's file; after a barrier that tells every rank whether every
write succeeded, rank 0 commits with the same rename-aside swap and
garbage-collects, and a second barrier returns the commit to every rank.
A rank that fails before the commit fails the save on every rank and
leaves the previous checkpoint as it was.  ``restore_latest`` restores
the step rank 0 picks, on every rank.  A restore reads each leaf's
logical rows, from whichever files hold them, and a rank of a process mesh
keeps its own rows of the per-rank ones, so a checkpoint written by ``P``
processes restores onto any process count, or onto one process.
Asynchronous saves are refused on a process mesh: their barrier would run
on the save thread beside the caller's collectives on the same group.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import faults

_SENTINEL = "MANIFEST.json"


def _flatten(tree) -> tuple[list[np.ndarray], Any]:
    """Host copies of the tree's leaves (tensors, numpy arrays or numbers)
    and its structure."""
    leaves, spec = pytree.tree_flatten(tree)
    out = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            out.append(x.numpy().copy() if x.dtype != torch.bfloat16
                       else x.float().numpy())
        else:
            out.append(np.asarray(x))
    return out, spec


def _placements(shardings, n: int) -> list:
    """One ``torch.device`` (or ``None``: the like-leaf's own) per leaf."""
    from repro_torch.core.containers import Mesh

    def device_of(p):
        if p is None:
            return None
        return p.device if isinstance(p, Mesh) else torch.device(p)

    if shardings is None or isinstance(shardings, (str, torch.device, Mesh)):
        return [device_of(shardings)] * n
    flat = pytree.tree_flatten(shardings)[0]
    if len(flat) != n:
        raise ValueError(f"shardings has {len(flat)} placements for {n} leaves")
    return [device_of(p) for p in flat]


class CheckpointManager:
    """Numbered checkpoints in ``directory``, the ``keep`` newest kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None
        # Serialises the commit swap, _gc and _recover against each other
        # (an async save writes on a thread while the caller may restore).
        self._io_lock = threading.Lock()
        self._recover()

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, *, blocking: bool = True, mesh=None,
             per_rank=None) -> str:
        """Write ``tree`` as checkpoint ``step``.  The leaves are copied to
        the host on the caller's thread; ``blocking=False`` writes the files
        on a thread (:meth:`wait` joins it).  The ``checkpoint.write`` fault
        point fires first, on the caller's thread, so an injected write
        fault reaches whoever supervises the save.

        On a process mesh (``mesh`` with a group; every rank calls this with
        the same ``step``) ``per_rank``, a tree of bools shaped as ``tree``,
        marks the leaves whose leading dimension is this rank's rows; the
        others are replicated and rank 0's are written (module docstring).
        ``blocking=False`` raises there."""
        faults.fault_point("checkpoint.write")
        leaves, spec = _flatten(tree)
        if _across(mesh):
            if not blocking:
                raise ValueError(
                    "blocking=False on a mesh of several processes: the commit's "
                    "barrier would run on the save thread beside this thread's "
                    "collectives on the same group; save with blocking=True")
            return self._write_ranks(step, leaves, str(spec), mesh,
                                     _rank_flags(per_rank, len(leaves)))
        if blocking:
            return self._write(step, leaves, str(spec))
        self.wait()
        self._pending = threading.Thread(target=self._write,
                                         args=(step, leaves, str(spec)), daemon=True)
        self._pending.start()
        return self._path(step)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, leaves, spec_str: str) -> str:
        final = self._path(step)
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": x for i, x in enumerate(leaves)})
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "treespec": spec_str,
            "shapes": [list(x.shape) for x in leaves],
            "dtypes": [str(x.dtype) for x in leaves],
        }
        with open(os.path.join(tmp, _SENTINEL), "w") as f:
            json.dump(manifest, f)
        self._commit(tmp, final)
        return final

    def _commit(self, tmp: str, final: str) -> None:
        """Rename-aside swap: (1) move the previous checkpoint aside, (2)
        move the new one in, (3) delete the old.  A crash after (1) leaves
        the old one complete under ``.old-<nonce>`` (rolled back by
        _recover); a crash after (2) leaves the new one committed."""
        old = None
        with self._io_lock:
            if os.path.exists(final):
                old = f"{final}.old-{uuid.uuid4().hex[:8]}"
                os.rename(final, old)
            os.rename(tmp, final)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
        self._gc()

    def _write_ranks(self, step: int, leaves, spec_str: str, mesh, flags) -> str:
        """The save across processes (module docstring): this rank's rows of
        the per-rank leaves, rank 0's replicated leaves and the manifest, a
        barrier, rank 0's commit, a barrier."""
        from repro_torch.core.collectives import agree

        final = self._path(step)
        # one directory for every rank: rank 0's nonce
        nonce = agree(mesh, int.from_bytes(os.urandom(4), "little"))
        tmp = f"{final}.tmp-{nonce:08x}"
        ranked = [i for i, f in enumerate(flags) if f]
        error = None
        try:
            for i in ranked:
                if leaves[i].ndim == 0:
                    raise ValueError(f"per-rank leaf {i} has no leading dimension")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, _rank_file(mesh.rank)),
                     **{f"leaf_{i}": leaves[i] for i in ranked})
            if mesh.rank == 0:
                np.savez(os.path.join(tmp, "arrays.npz"),
                         **{f"leaf_{i}": x for i, x in enumerate(leaves) if not flags[i]})
        except Exception as e:  # noqa: BLE001 - reported to every rank, re-raised below
            error = e
        # barrier 1: whether every rank wrote its rows, and how many
        rows = _gather_ints(mesh, [error is None] + [leaves[i].shape[0] for i in ranked])
        failed = [r for r in range(mesh.n_ranks) if not rows[r][0]]
        if not failed and mesh.rank == 0:
            try:
                bounds = np.concatenate([np.zeros((1, len(ranked)), np.int64),
                                         np.cumsum(rows[:, 1:], 0)])
                shapes = [list(x.shape) for x in leaves]
                for j, i in enumerate(ranked):
                    shapes[i][0] = int(bounds[-1, j])
                manifest = {
                    "step": step,
                    "n_leaves": len(leaves),
                    "treespec": spec_str,
                    "shapes": shapes,
                    "dtypes": [str(x.dtype) for x in leaves],
                    "ranks": {
                        "files": [_rank_file(r) for r in range(mesh.n_ranks)],
                        "rows": {str(i): [[int(bounds[r, j]), int(bounds[r + 1, j])]
                                          for r in range(mesh.n_ranks)]
                                 for j, i in enumerate(ranked)},
                    },
                }
                with open(os.path.join(tmp, _SENTINEL), "w") as f:
                    json.dump(manifest, f)
                self._commit(tmp, final)
            except Exception as e:  # noqa: BLE001 - reported to every rank
                error = e
        elif failed and mesh.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        # barrier 2: whether rank 0 committed
        committed = bool(_gather_ints(mesh, [not failed and error is None])[0][0])
        if error is not None:
            raise error
        if failed:
            raise RuntimeError(f"checkpoint {step} was not committed: rank(s) {failed} of "
                               f"{mesh.n_ranks} failed to write their rows")
        if not committed:
            raise RuntimeError(f"checkpoint {step} was not committed: rank 0's commit failed")
        return final

    def _recover(self):
        """Roll back swaps interrupted between the rename aside and the
        commit: a complete ``step_N.old-<nonce>`` whose ``step_N`` is missing
        goes back into place; one whose final exists is garbage."""
        with self._io_lock:
            for name in os.listdir(self.dir):
                if ".old-" not in name:
                    continue
                full = os.path.join(self.dir, name)
                final = os.path.join(self.dir, name.split(".old-")[0])
                if os.path.exists(final):
                    shutil.rmtree(full, ignore_errors=True)
                elif os.path.exists(os.path.join(full, _SENTINEL)):
                    try:
                        os.rename(full, final)
                    except OSError:
                        pass
                else:
                    shutil.rmtree(full, ignore_errors=True)

    def _gc(self):
        self._recover()
        with self._io_lock:
            steps = self.all_steps()
            for s in steps[: -self.keep] if self.keep else []:
                shutil.rmtree(self._path(s), ignore_errors=True)
            # Orphaned tmp dirs of crashed saves (``.old-`` dirs are
            # _recover's: one may hold the only complete copy of a step).
            for name in os.listdir(self.dir):
                if ".tmp-" in name:
                    shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_") and ".tmp-" not in name
                    and ".old-" not in name
                    and os.path.exists(os.path.join(full, _SENTINEL))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, shardings=None, *, mesh=None, per_rank=None):
        """Checkpoint ``step`` onto the structure of ``like`` (elastic: any
        device or mesh).  Each leaf gets the dtype of ``like``'s leaf and
        goes to its placement: ``shardings`` is one placement for every
        leaf or a tree of them matching ``like``, a placement being a device
        (or its name) or a ``containers.Mesh`` (its device); ``None``, the
        default, keeps each leaf on the device of ``like``'s.  Raises
        ``ValueError`` when the leaf counts differ.

        A leaf is read as its logical array, whichever process count wrote
        it; on a process mesh (``mesh``) a leaf that ``per_rank`` marks
        keeps this rank's rows of it, ``rank * L / P ...`` of its ``L``."""
        path = self._path(step)
        with open(os.path.join(path, _SENTINEL)) as f:
            manifest = json.load(f)
        like_leaves, spec = pytree.tree_flatten(like)
        n = manifest["n_leaves"]
        if len(like_leaves) != n:
            raise ValueError(f"checkpoint has {n} leaves, target has "
                             f"{len(like_leaves)}")
        flags = _rank_flags(per_rank, n) if _across(mesh) else [False] * n
        leaves = _read_leaves(path, manifest, flags, mesh)
        places = _placements(shardings, len(leaves))
        out = []
        for arr, lk, place in zip(leaves, like_leaves, places):
            if isinstance(lk, torch.Tensor):
                dev = lk.device if place is None else place
                out.append(torch.from_numpy(np.array(arr, copy=True)).to(dev, lk.dtype))
            else:
                out.append(np.asarray(arr).astype(np.asarray(lk).dtype))
        return pytree.tree_unflatten(out, spec)

    def restore_latest(self, like, shardings=None, *, mesh=None, per_rank=None):
        """``(step, tree)`` of the newest complete checkpoint, or ``(None,
        None)`` when there is none.  On a process mesh (``mesh``) rank 0
        rolls interrupted swaps back and picks the step, and every rank
        restores that one (:meth:`restore` with ``mesh`` and
        ``per_rank``)."""
        if _across(mesh):
            from repro_torch.core.collectives import agree

            step = None
            if mesh.rank == 0:
                self._recover()
                step = self.latest_step()
            step = agree(mesh, -1 if step is None else step)
            if step < 0:
                return None, None
            return step, self.restore(step, like, shardings, mesh=mesh, per_rank=per_rank)
        self._recover()
        # Retry: an async save's _gc may sweep the step between our listing
        # and our read; the next listing sees the newer step.
        for _ in range(8):
            step = self.latest_step()
            if step is None:
                # An unlocked listing can race _gc; under the lock no swap or
                # sweep is in flight, so an empty listing means none exists.
                with self._io_lock:
                    step = self.latest_step()
                if step is None:
                    return None, None
            try:
                return step, self.restore(step, like, shardings)
            except (FileNotFoundError, NotADirectoryError):
                continue
        raise RuntimeError(f"restore_latest: checkpoints in {self.dir} kept "
                           "disappearing mid-read")


def _across(mesh) -> bool:
    """Whether ``mesh`` spans processes (carries a group)."""
    return mesh is not None and getattr(mesh, "group", None) is not None


def _rank_file(rank: int) -> str:
    return f"rank_{rank:05d}.npz"


def _rank_flags(per_rank, n: int) -> list[bool]:
    """One bool a leaf: ``per_rank`` (a tree of bools shaped as the
    checkpoint's tree; None: every leaf replicated) flattened."""
    if per_rank is None:
        return [False] * n
    flags = [bool(f) for f in pytree.tree_flatten(per_rank)[0]]
    if len(flags) != n:
        raise ValueError(f"per_rank has {len(flags)} flags for {n} leaves")
    return flags


def _gather_ints(mesh, values) -> np.ndarray:
    """``values`` (ints) of every rank as ``[P, len(values)]`` int64, rank 0
    first: one all-gather over ``mesh``'s group, so also a barrier."""
    from repro_torch.core.collectives import gather_rows

    t = torch.tensor([[int(v) for v in values]], dtype=torch.int64, device=mesh.device)
    return gather_rows(mesh, t).cpu().numpy()


def _read_leaves(path: str, manifest: dict, flags, mesh) -> list[np.ndarray]:
    """The checkpoint's leaves as host arrays: each one logical, or, where
    ``flags`` marks it, this rank's rows of it (rank ``r`` of ``P`` keeps
    ``[r L / P, (r + 1) L / P)``); per-rank leaves are read from the rank
    files that hold those rows, the others from ``arrays.npz``."""
    ranks = manifest.get("ranks")
    files: dict[str, Any] = {}

    def npz(name):
        if name not in files:
            files[name] = np.load(os.path.join(path, name))
        return files[name]

    out = []
    try:
        for i in range(manifest["n_leaves"]):
            shape = manifest["shapes"][i]
            lo, hi = 0, shape[0] if shape else 0
            if flags[i]:
                if not shape or shape[0] % mesh.n_ranks:
                    raise ValueError(f"leaf {i} of logical shape {shape} does not split "
                                     f"into {mesh.n_ranks} ranks' rows")
                per = shape[0] // mesh.n_ranks
                lo, hi = mesh.rank * per, (mesh.rank + 1) * per
            rows = None if ranks is None else ranks["rows"].get(str(i))
            if rows is None:
                arr = npz("arrays.npz")[f"leaf_{i}"]
                out.append(arr[lo:hi] if flags[i] else arr)
                continue
            parts = [npz(name)[f"leaf_{i}"][max(lo, a) - a:min(hi, b) - a]
                     for name, (a, b) in zip(ranks["files"], rows) if a < hi and b > lo]
            out.append(np.concatenate(parts) if parts else np.zeros(
                [0] + shape[1:], manifest["dtypes"][i]))
    finally:
        for f in files.values():
            f.close()
    return out


# ---------------------------------------------------------------------------
# BlockStore: atomic byte-level block spill for out-of-core containers
# ---------------------------------------------------------------------------


class BlockStore:
    """Crash-safe named byte blobs: the spill target for cold blocks of
    ``repro_torch.core.containers.ChunkedDistVector``.  A blob is written to
    ``<name>.tmp-<nonce>`` and moved into place with ``os.replace``, so a
    reader only ever sees complete blobs."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.bytes_written = 0

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.blk")

    def put(self, name: str, data: bytes) -> int:
        final = self._path(name)
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, final)
        self.bytes_written += len(data)
        return len(data)

    def get(self, name: str) -> bytes:
        with open(self._path(name), "rb") as f:
            return f.read()

    def has(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def delete(self, name: str) -> None:
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass
