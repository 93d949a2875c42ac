"""Multi-node bring-up and the MapReduce engine's ("node", "data") mesh.

The counterpart of ``repro/launch/mesh.py`` (its multi-host half; the
production LM meshes come with LM training).  Nothing here touches a device
or a process group when imported.

* ``init_distributed(...)`` — ``torch.distributed.init_process_group``,
  gated: a no-op that returns ``False`` on one process.
* ``process_count()`` / ``process_index()`` — the process group's size and
  rank (1 and 0 without one).
* ``make_node_data_mesh(n_nodes, n_shards=, device=)`` — the engine's 2-D
  mesh: the stacked shards of one device split into ``n_nodes`` node rows
  of ``n_shards / n_nodes``, shard ``s = node * n_data + d``.  The
  hierarchical collectives reduce over each row at full precision first and
  cross the node hop second (``core/collectives.py``).

The port runs every multi-node topology in one process, as the reference
runs its simulated one: one program over the stacked shards.  Collectives
across processes (NCCL across cards, inside captured graphs) are not built,
so with more than one process ``make_node_data_mesh`` raises rather than
simulate a topology the caller did not ask for.
"""
from __future__ import annotations

import torch

from repro_torch.core import containers as C

__all__ = ["init_distributed", "make_node_data_mesh", "process_count", "process_index"]


def _group_up() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the default process group (1 without one)."""
    return torch.distributed.get_world_size() if _group_up() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return torch.distributed.get_rank() if _group_up() else 0


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None, process_id: int | None = None,
                     *, backend: str = "gloo", **kwargs) -> bool:
    """Bring up the process group; returns whether one came up.

    Call once on every process of a multi-process launch::

        init_distributed("tcp://host0:1234", num_processes=8, process_id=rank)

    On one process (no coordinator, ``num_processes`` absent or 1) it is a
    no-op that returns ``False``, and ``make_node_data_mesh(n)`` splits the
    local shards into ``n`` node rows instead.
    """
    if coordinator_address is None and num_processes in (None, 1):
        return False
    torch.distributed.init_process_group(
        backend, init_method=coordinator_address, world_size=num_processes,
        rank=process_id, **kwargs)
    return True


def make_node_data_mesh(n_nodes: int | None = None, *, n_shards: int = 8,
                        device=None) -> C.Mesh:
    """A 2-D ``("node", "data")`` mesh over ``n_shards`` shards stacked on
    ``device`` (the card unless the caller names another).

    ``n_nodes`` defaults to ``process_count()``, one node row a process as
    in the reference.  ``ValueError`` when the shards do not split evenly;
    ``NotImplementedError`` when more than one process is up: collectives
    across processes are ROADMAP.md's Queue 1 item 6b.
    """
    procs = process_count()
    if procs > 1:
        raise NotImplementedError(
            f"{procs} processes are up, but the port's collectives run inside one "
            "process only; collectives across processes over torch.distributed "
            "are ROADMAP.md, Queue 1 item 6b")
    nodes = 1 if n_nodes is None else int(n_nodes)
    if nodes < 1 or n_shards < 1 or n_shards % nodes:
        raise ValueError(f"cannot split {n_shards} shards into {nodes} node rows")
    return C.Mesh(nodes, n_shards // nodes, C.resolve_device(device))
