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

    def save(self, step: int, tree, *, blocking: bool = True) -> str:
        """Write ``tree`` as checkpoint ``step``.  The leaves are copied to
        the host on the caller's thread; ``blocking=False`` writes the files
        on a thread (:meth:`wait` joins it).  The ``checkpoint.write`` fault
        point fires first, on the caller's thread, so an injected write
        fault reaches whoever supervises the save."""
        faults.fault_point("checkpoint.write")
        leaves, spec = _flatten(tree)
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
        # Rename-aside swap: (1) move the previous checkpoint aside, (2) move
        # the new one in, (3) delete the old.  A crash after (1) leaves the
        # old one complete under ``.old-<nonce>`` (rolled back by _recover);
        # a crash after (2) leaves the new one committed.
        old = None
        with self._io_lock:
            if os.path.exists(final):
                old = f"{final}.old-{uuid.uuid4().hex[:8]}"
                os.rename(final, old)
            os.rename(tmp, final)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
        self._gc()
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

    def restore(self, step: int, like, shardings=None):
        """Checkpoint ``step`` onto the structure of ``like`` (elastic: any
        device or mesh).  Each leaf gets the dtype of ``like``'s leaf and
        goes to its placement: ``shardings`` is one placement for every
        leaf or a tree of them matching ``like``, a placement being a device
        (or its name) or a ``containers.Mesh`` (its device); ``None``, the
        default, keeps each leaf on the device of ``like``'s.  Raises
        ``ValueError`` when the leaf counts differ."""
        path = self._path(step)
        with open(os.path.join(path, _SENTINEL)) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            leaves = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
        like_leaves, spec = pytree.tree_flatten(like)
        if len(like_leaves) != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, target has "
                             f"{len(like_leaves)}")
        places = _placements(shardings, len(leaves))
        out = []
        for arr, lk, place in zip(leaves, like_leaves, places):
            if isinstance(lk, torch.Tensor):
                dev = lk.device if place is None else place
                out.append(torch.from_numpy(np.array(arr, copy=True)).to(dev, lk.dtype))
            else:
                out.append(np.asarray(arr).astype(np.asarray(lk).dtype))
        return pytree.tree_unflatten(out, spec)

    def restore_latest(self, like, shardings=None):
        """``(step, tree)`` of the newest complete checkpoint, or ``(None,
        None)`` when there is none."""
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
