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

Across processes, the reference's stated protocol, which it collapses to one
process: each rank writes only its own shards into the step's ``tmp-``
directory (a file a rank); rank 0 writes the replicated leaves
(``arrays.npz``) and the manifest; after a barrier that tells every rank
whether every write succeeded, rank 0 commits with the same rename-aside
swap and garbage-collects, and a second barrier returns the commit to every
rank.  A rank that fails before the commit fails the save on every rank and
leaves the previous checkpoint as it was.  Every rank calls ``save`` and
``restore_latest``; the latter restores the step rank 0 picks.  Two kinds of
tree take this path:

* a tree with ``DTensor`` leaves (sharded LM state, all on one
  ``DeviceMesh``, whose group the barriers run over; rank ``r`` is the
  mesh coordinate's row-major index).  Each shard is written once, by the
  rank whose coordinate is 0 on every mesh dim where the leaf is
  ``Replicate``, into the rank's raw file ``rank_<r>.bin`` (its shards one
  after another, bf16 as its bits: no zip, no CRC, and a restore reads
  only the bytes it keeps); the manifest holds every written box (file,
  global offset, shape, byte offset).  A ``Partial`` leaf (partial sums,
  not values) raises.
* ``save``/``restore`` with ``mesh=`` (a ``containers.Mesh`` carrying a
  ``torch.distributed`` group) and ``per_rank=``, which marks the leaves
  each rank holds its own rows of (a program's carry); each rank's rows go
  to ``rank_<r>.npz`` and the manifest holds the rows of every file.

A restore reads, for each leaf, the region it keeps from whichever files'
boxes overlap it: the whole leaf for a plain target; this rank's shard for a
``DTensor`` target (``shardings`` of ``sharding.NamedSharding``, or the
placements of ``like``'s ``DTensor`` leaves); a rank's rows for a
``per_rank`` leaf on a process mesh.  So a checkpoint written by ``P``
processes on any mesh restores onto any other mesh shape, process count,
or one process; no rank builds a whole leaf it does not keep (except when
the checkpoint stored the leaf whole, in ``arrays.npz``).  Asynchronous
saves are refused across several processes: their barrier would run on the
save thread beside the caller's collectives on the same group.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import threading
import uuid
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils import _pytree as pytree

from repro_torch.core import faults

_SENTINEL = "MANIFEST.json"


def _host(x) -> np.ndarray:
    """A host copy of a tensor (bf16 widened to f32, which is exact), numpy
    array or number, sharing no memory with it."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    elif x.device.type == "cpu":
        x = x.clone()
    return x.cpu().numpy()


def _bits(x: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor's bits as written to a rank file (bf16 as its
    2-byte words), sharing no memory with it."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    if x.device.type == "cpu":
        x = x.clone()
    return x.cpu().numpy()


def _bits_dtype(dtype: torch.dtype) -> str:
    """The manifest's name of a rank file's dtype (numpy's, or bfloat16)."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a manifest dtype's values (bf16: its bits)."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _write_raw(path: str, arrays) -> None:
    """``arrays`` one after another into the file ``path``."""
    with open(path, "wb") as f:
        for x in arrays:
            f.write(memoryview(np.ascontiguousarray(x)).cast("B"))


# -- process groups -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Group:
    """The processes that save or restore one checkpoint together:
    ``gather(ints)`` is every rank's ``ints`` as ``[P, len(ints)]`` int64,
    rank 0's row first (an all-gather, so a barrier)."""

    rank: int
    n_ranks: int
    gather: Callable[[list], np.ndarray]


def _across(mesh) -> bool:
    """Whether ``mesh`` spans processes (carries a group)."""
    return mesh is not None and getattr(mesh, "group", None) is not None


def _mesh_group(mesh) -> _Group:
    """The group of a ``containers.Mesh`` of processes."""
    return _Group(mesh.rank, mesh.n_ranks, lambda values: _gather_ints(mesh, values))


def _device_mesh(meshes) -> Any:
    """The one ``DeviceMesh`` of ``meshes`` (None when empty)."""
    found = None
    for m in meshes:
        if found is None:
            found = m
        elif m is not found and m != found:
            raise ValueError(f"the tree's DTensors lie on two meshes, {found} and {m}; "
                             "a checkpoint saves or restores one mesh's tree")
    return found


def _device_group(dm) -> _Group:
    """The group of a ``DeviceMesh``: rank ``r`` is this rank's coordinate
    in row-major order; gathers run over the mesh's own groups (none for a
    mesh of one rank, where a gather is this rank's own row)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(f"the process group of {dm} is not up: a checkpoint of "
                           "DTensors saves and restores over its mesh's group")
    rank = int(np.ravel_multi_index(tuple(dm.get_coordinate()), tuple(dm.shape)))

    def gather(values):
        if dm.size() == 1:
            return np.array([[int(v) for v in values]], dtype=np.int64)
        t = torch.tensor([[int(v) for v in values]], dtype=torch.int64,
                         device=dm.device_type)
        whole = DTensor.from_local(t, dm, [Shard(0)] * dm.ndim, run_check=False)
        return whole.full_tensor().cpu().numpy()

    return _Group(rank, dm.size(), gather)


def _shard_box(x: DTensor, coord) -> tuple[bool, list, list]:
    """``(writes, offset, shape)`` of this rank's shard of ``x``: it writes
    the shard when its coordinate is 0 on every mesh dim where ``x`` is
    replicated."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    for p in x.placements:
        if not isinstance(p, (Shard, Replicate)):
            raise ValueError(f"a DTensor leaf with placement {p} cannot be saved: only "
                             "Shard and Replicate leaves hold the leaf's values "
                             "(redistribute a Partial one first)")
    shape, offset = compute_local_shape_and_global_offset(x.shape, x.device_mesh,
                                                          x.placements)
    writes = all(c == 0 for c, p in zip(coord, x.placements) if isinstance(p, Replicate))
    return writes, list(offset), list(shape)


# -- placements ---------------------------------------------------------------------


def _targets(shardings, like_leaves) -> list:
    """Where each restored leaf goes: a ``torch.device``, ``None`` (the
    like-leaf's own device) or ``(DeviceMesh, placements)``.  ``shardings``
    is one placement for every leaf or a tree of them matching ``like``, a
    placement being a device (or its name), a ``containers.Mesh`` (its
    device) or a ``sharding.NamedSharding``; ``None`` keeps each
    ``DTensor`` like-leaf on its own mesh and placements."""
    from repro_torch.core.containers import Mesh
    from repro_torch.distributed.sharding import NamedSharding

    def target(p, like):
        if p is None:
            return (like.device_mesh, tuple(like.placements)) if isinstance(
                like, DTensor) else None
        if isinstance(p, NamedSharding):
            return (p.mesh, p.placements)
        return p.device if isinstance(p, Mesh) else torch.device(p)

    n = len(like_leaves)
    if shardings is None or isinstance(shardings, (str, torch.device, Mesh, NamedSharding)):
        flat = [shardings] * n
    else:
        flat = pytree.tree_flatten(shardings)[0]
        if len(flat) != n:
            raise ValueError(f"shardings has {len(flat)} placements for {n} leaves")
    return [target(p, lk) for p, lk in zip(flat, like_leaves)]


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

        A tree with ``DTensor`` leaves is saved by every rank of their mesh
        (module docstring).  On a process mesh (``mesh`` with a group; every
        rank calls this with the same ``step``) ``per_rank``, a tree of
        bools shaped as ``tree``, marks the leaves whose leading dimension
        is this rank's rows; the others are replicated and rank 0's are
        written.  ``blocking=False`` raises across several processes."""
        faults.fault_point("checkpoint.write")
        flat, spec = pytree.tree_flatten(tree)
        dm = _device_mesh(x.device_mesh for x in flat if isinstance(x, DTensor))
        if dm is not None:
            if _across(mesh) or per_rank is not None:
                raise ValueError("a tree of DTensors is saved over its own mesh: pass "
                                 "no mesh= or per_rank=")
            group = _device_group(dm)
            job = self._shards_job(step, flat, str(spec), group, tuple(dm.get_coordinate()))
        elif _across(mesh):
            group = _mesh_group(mesh)
            job = self._rows_job(step, [_host(x) for x in flat], str(spec), group,
                                 _rank_flags(per_rank, len(flat)))
        else:
            group, leaves = None, [_host(x) for x in flat]

            def job():
                return self._write(step, leaves, str(spec))
        if blocking:
            return job()
        if group is not None and group.n_ranks > 1:
            raise ValueError(
                "blocking=False on a mesh of several processes: the commit's "
                "barrier would run on the save thread beside this thread's "
                "collectives on the same group; save with blocking=True")
        self.wait()
        self._pending = threading.Thread(target=job, daemon=True)
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

    def _rows_job(self, step: int, leaves, spec_str: str, group: _Group, flags):
        """The save of a process mesh's tree: this rank's rows of the
        per-rank leaves, rank 0's replicated leaves (``arrays.npz``), and a
        manifest of every rank's rows."""
        ranked = [i for i, f in enumerate(flags) if f]

        def write(tmp):
            for i in ranked:
                if leaves[i].ndim == 0:
                    raise ValueError(f"per-rank leaf {i} has no leading dimension")
            np.savez(os.path.join(tmp, _rank_file(group.rank)),
                     **{f"leaf_{i}": leaves[i] for i in ranked})
            if group.rank == 0:
                np.savez(os.path.join(tmp, "arrays.npz"),
                         **{f"leaf_{i}": x for i, x in enumerate(leaves) if not flags[i]})

        def manifest(rows):
            bounds = np.concatenate([np.zeros((1, len(ranked)), np.int64),
                                     np.cumsum(rows, 0)])
            shapes = [list(x.shape) for x in leaves]
            for j, i in enumerate(ranked):
                shapes[i][0] = int(bounds[-1, j])
            return {
                "step": step,
                "n_leaves": len(leaves),
                "treespec": spec_str,
                "shapes": shapes,
                "dtypes": [str(x.dtype) for x in leaves],
                "ranks": {
                    "files": [_rank_file(r) for r in range(group.n_ranks)],
                    "rows": {str(i): [[int(bounds[r, j]), int(bounds[r + 1, j])]
                                      for r in range(group.n_ranks)]
                             for j, i in enumerate(ranked)},
                },
            }

        ints = [leaves[i].shape[0] if leaves[i].ndim else 0 for i in ranked]
        return lambda: self._write_across(step, group, ints, write, manifest)

    def _shards_job(self, step: int, flat, spec_str: str, group: _Group, coord):
        """The save of a tree of ``DTensor``s: each shard once, by the rank
        whose coordinate is 0 on the leaf's replicated mesh dims, into the
        rank's raw file (``rank_<r>.bin``, its shards in leaf order, bf16 as
        its bits); rank 0's plain leaves (``arrays.npz``); a manifest of
        every written box (file, global offset, shape, byte offset).  The
        shards are copied to the host here, on the caller's thread."""
        sharded = [i for i, x in enumerate(flat) if isinstance(x, DTensor)]
        boxes = {i: _shard_box(flat[i], coord) for i in sharded}
        mine = [_bits(flat[i].to_local()) for i in sharded if boxes[i][0]]
        plain = ({i: _host(x) for i, x in enumerate(flat) if not isinstance(x, DTensor)}
                 if group.rank == 0 else {})
        shapes = [list(x.shape) for x in flat]
        dtypes = [_bits_dtype(x.dtype) if isinstance(x, DTensor) else str(_host(x).dtype)
                  for x in flat]
        ints = [v for i in sharded for v in [int(boxes[i][0])] + boxes[i][1] + boxes[i][2]]

        def write(tmp):
            if mine:
                _write_raw(os.path.join(tmp, _raw_file(group.rank)), mine)
            if plain:
                np.savez(os.path.join(tmp, "arrays.npz"),
                         **{f"leaf_{i}": x for i, x in plain.items()})

        def manifest(table):
            written = {str(i): [] for i in sharded}
            for r in range(group.n_ranks):
                col, at = 0, 0
                for i in sharded:
                    nd = len(shapes[i])
                    if table[r, col]:
                        shape = [int(v) for v in table[r, col + 1 + nd:col + 1 + 2 * nd]]
                        written[str(i)].append(
                            [_raw_file(r), [int(v) for v in table[r, col + 1:col + 1 + nd]],
                             shape, at])
                        at += math.prod(shape) * _np_dtype(dtypes[i]).itemsize
                    col += 1 + 2 * nd
            return {"step": step, "n_leaves": len(flat), "treespec": spec_str,
                    "shapes": shapes, "dtypes": dtypes, "boxes": written}

        return lambda: self._write_across(step, group, ints, write, manifest)

    def _write_across(self, step: int, group: _Group, ints, write, manifest_of) -> str:
        """The save across processes (module docstring): ``write(tmp)``
        writes this rank's files; after barrier 1, which gathers every
        rank's success and ``ints`` (the same count on every rank), rank 0
        writes ``manifest_of([P, len(ints)] table)`` and commits; barrier 2
        returns the commit."""
        final = self._path(step)
        # one directory for every rank: rank 0's nonce
        nonce = int(group.gather([int.from_bytes(os.urandom(4), "little")])[0, 0])
        tmp = f"{final}.tmp-{nonce:08x}"
        error = None
        try:
            os.makedirs(tmp, exist_ok=True)
            write(tmp)
        except Exception as e:  # noqa: BLE001 - reported to every rank, re-raised below
            error = e
        # barrier 1: whether every rank wrote its files, and their numbers
        table = group.gather([error is None] + list(ints))
        failed = [r for r in range(group.n_ranks) if not table[r, 0]]
        if not failed and group.rank == 0:
            try:
                with open(os.path.join(tmp, _SENTINEL), "w") as f:
                    json.dump(manifest_of(table[:, 1:]), f)
                self._commit(tmp, final)
            except Exception as e:  # noqa: BLE001 - reported to every rank
                error = e
        elif failed and group.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        # barrier 2: whether rank 0 committed
        committed = bool(group.gather([not failed and error is None])[0, 0])
        if error is not None:
            raise error
        if failed:
            raise RuntimeError(f"checkpoint {step} was not committed: rank(s) {failed} of "
                               f"{group.n_ranks} failed to write their files")
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
        (or its name), a ``containers.Mesh`` (its device) or a
        ``sharding.NamedSharding`` (a ``DTensor`` with its placements, this
        rank's shard read); ``None``, the default, keeps each leaf on the
        device of ``like``'s, and a ``DTensor`` like-leaf's mesh and
        placements.  Raises ``ValueError`` when the leaf counts differ, and
        ``RuntimeError`` for a ``DTensor`` target whose group is not up.

        A leaf is read as its logical array, whichever process count and
        mesh wrote it; on a process mesh (``mesh``) a leaf that ``per_rank``
        marks keeps this rank's rows of it, ``rank * L / P ...`` of its
        ``L``."""
        import torch.distributed as dist

        path = self._path(step)
        with open(os.path.join(path, _SENTINEL)) as f:
            manifest = json.load(f)
        like_leaves, spec = pytree.tree_flatten(like)
        n = manifest["n_leaves"]
        if len(like_leaves) != n:
            raise ValueError(f"checkpoint has {n} leaves, target has "
                             f"{len(like_leaves)}")
        flags = _rank_flags(per_rank, n) if _across(mesh) else [False] * n
        targets = _targets(shardings, like_leaves)
        if any(isinstance(t, tuple) for t in targets) and not dist.is_initialized():
            raise RuntimeError("restore onto DTensor placements: the mesh's process "
                               "group is not up")
        reader = _Reader(path, manifest)
        out = []
        try:
            for i, (lk, target) in enumerate(zip(like_leaves, targets)):
                shape = manifest["shapes"][i]
                if isinstance(target, tuple):
                    out.append(reader.dtensor(i, shape, *target, lk.dtype))
                    continue
                lo, size = [0] * len(shape), list(shape)
                if flags[i]:
                    if not shape or shape[0] % mesh.n_ranks:
                        raise ValueError(f"leaf {i} of logical shape {shape} does not "
                                         f"split into {mesh.n_ranks} ranks' rows")
                    size[0] = shape[0] // mesh.n_ranks
                    lo[0] = mesh.rank * size[0]
                arr = reader.region(i, lo, size)
                if isinstance(lk, torch.Tensor):
                    dev = lk.device if target is None else target
                    out.append(reader.tensor(i, arr, dev, lk.dtype))
                elif manifest["dtypes"][i] == "bfloat16":
                    out.append(reader.tensor(i, arr, "cpu", torch.float32).numpy().astype(
                        np.asarray(lk).dtype))
                else:
                    out.append(np.asarray(arr).astype(np.asarray(lk).dtype))
        finally:
            reader.close()
        return pytree.tree_unflatten(out, spec)

    def restore_latest(self, like, shardings=None, *, mesh=None, per_rank=None):
        """``(step, tree)`` of the newest complete checkpoint, or ``(None,
        None)`` when there is none.  Across processes (a process ``mesh``,
        or ``DTensor`` targets: ``like``'s ``DTensor`` leaves or
        ``shardings``' ``NamedSharding``\\ s) rank 0 rolls interrupted swaps
        back and picks the step, and every rank restores that one
        (:meth:`restore`)."""
        if _across(mesh):
            group = _mesh_group(mesh)
        else:
            like_leaves = pytree.tree_leaves(like)
            dm = _device_mesh(t[0] for t in _targets(shardings, like_leaves)
                              if isinstance(t, tuple))
            group = None if dm is None else _device_group(dm)
        if group is not None:
            step = None
            if group.rank == 0:
                self._recover()
                step = self.latest_step()
            step = int(group.gather([-1 if step is None else step])[0, 0])
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


def _rank_file(rank: int) -> str:
    return f"rank_{rank:05d}.npz"


def _raw_file(rank: int) -> str:
    return f"rank_{rank:05d}.bin"


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


class _Reader:
    """Regions of a checkpoint's leaves, each assembled from the saved boxes
    that overlap it: a ``DTensor`` checkpoint's shards (``"boxes"``, in raw
    rank files, read through a memory map: only the overlap is read), a
    process mesh's rank rows (``"ranks"``), or the whole leaf in
    ``arrays.npz``."""

    def __init__(self, path: str, manifest: dict):
        self.path, self.manifest = path, manifest
        self.files: dict[str, Any] = {}

    def close(self):
        for f in self.files.values():
            f.close()

    def boxes(self, i: int) -> list:
        """``[(file, offset, shape, byte offset or None)]`` of leaf ``i``'s
        saved parts."""
        shape = self.manifest["shapes"][i]
        boxes = self.manifest.get("boxes", {}).get(str(i))
        if boxes is not None:
            return boxes
        ranks = self.manifest.get("ranks")
        rows = None if ranks is None else ranks["rows"].get(str(i))
        if rows is None:
            return [("arrays.npz", [0] * len(shape), shape, None)]
        return [(name, [a] + [0] * (len(shape) - 1), [b - a] + shape[1:], None)
                for name, (a, b) in zip(ranks["files"], rows)]

    def _part(self, i: int, box, whole: bool) -> np.ndarray:
        """A saved part: the array in its ``.npz``, or, in a raw file, a
        fresh copy (``whole``) or a memory map of it."""
        name, _, shape, at = box
        if at is None:
            if name not in self.files:
                self.files[name] = np.load(os.path.join(self.path, name))
            return self.files[name][f"leaf_{i}"]
        dtype, path = _np_dtype(self.manifest["dtypes"][i]), os.path.join(self.path, name)
        if whole:
            return np.fromfile(path, dtype, count=math.prod(shape), offset=at).reshape(shape)
        return np.memmap(path, dtype, mode="r", offset=at, shape=tuple(shape))

    def region(self, i: int, lo, size) -> np.ndarray:
        """Leaf ``i``'s values at ``[lo, lo + size)`` (a fresh array; a bf16
        leaf of a raw file as its bits, int16)."""
        boxes = self.boxes(i)
        box = boxes[0]
        if len(boxes) == 1 and list(box[1]) == list(lo) and list(box[2]) == list(size):
            return self._part(i, box, whole=True)
        out = np.empty(size, dtype=_np_dtype(self.manifest["dtypes"][i]))
        covered = 0
        for box in boxes:
            off, shape = box[1], box[2]
            a = [max(x, o) for x, o in zip(lo, off)]
            b = [min(x + s, o + t) for x, s, o, t in zip(lo, size, off, shape)]
            if any(p >= q for p, q in zip(a, b)):
                continue
            src = self._part(i, box, whole=False)
            out[tuple(slice(p - x, q - x) for p, q, x in zip(a, b, lo))] = \
                src[tuple(slice(p - o, q - o) for p, q, o in zip(a, b, off))]
            covered += math.prod(q - p for p, q in zip(a, b))
        if covered != math.prod(size):
            raise ValueError(f"checkpoint leaf {i}: the saved parts cover {covered} of "
                             f"the {math.prod(size)} values at {list(lo)} + {list(size)}")
        return out

    def tensor(self, i: int, arr: np.ndarray, device, dtype) -> torch.Tensor:
        """``arr``, a region of leaf ``i``, as a tensor of ``dtype`` on
        ``device``."""
        t = torch.from_numpy(arr)
        if self.manifest["dtypes"][i] == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device, dtype)

    def dtensor(self, i: int, shape, dm, placements, dtype) -> DTensor:
        """Leaf ``i`` as a ``DTensor`` on ``dm`` with ``placements``: this
        rank's shard read, on the mesh's device."""
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        size, lo = compute_local_shape_and_global_offset(shape, dm, placements)
        local = self.tensor(i, self.region(i, list(lo), list(size)), dm.device_type, dtype)
        stride = tuple(math.prod(shape[k + 1:]) for k in range(len(shape)))
        return DTensor.from_local(local, dm, placements, run_check=False,
                                  shape=torch.Size(shape), stride=stride)


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
