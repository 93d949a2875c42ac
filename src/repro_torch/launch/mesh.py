"""Multi-node bring-up, the MapReduce engine's ("node", "data") mesh and
the LM stack's production meshes.

The counterpart of ``repro/launch/mesh.py``.  Nothing here touches a device
or a process group when imported.

* ``init_distributed(...)`` — ``torch.distributed.init_process_group``,
  gated: a no-op that returns ``False`` on one process.  The backend
  defaults to ``"nccl"`` for the card and ``"gloo"`` for the CPU.
* ``process_count()`` / ``process_index()`` — the process group's size and
  rank (1 and 0 without one).
* ``make_node_data_mesh(n_nodes, n_shards=, device=)`` — the engine's 2-D
  mesh: ``n_shards`` shards in ``n_nodes`` node rows of ``n_shards /
  n_nodes``, shard ``s = node * n_data + d``.  The hierarchical collectives
  reduce over each row at full precision first and cross the node hop
  second (``core/collectives.py``).

Without a process group every row lives in this process, stacked on one
device, as the reference simulates its topology on one host.  With a group
up (``init_distributed``, or the caller's own ``init_process_group``, even
of one process) each process is one node row, as each JAX process is under
``jax.distributed``: it holds its ``n_shards / P`` shards, the intra-node
hop stays in the process, and the inter-node hop crosses processes through
``torch.distributed`` (``core.collectives.ProcessCollectives``).  Every
process then runs the same driver call on the same arguments and ends with
the same result.

Starting ``P`` processes on real cards (one card each)::

    torchrun --nproc-per-node 4 job.py          # or any launcher that sets
                                                # RANK/WORLD_SIZE/MASTER_ADDR
    # job.py, on every rank:
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    init_distributed("env://", num_processes=int(os.environ["WORLD_SIZE"]),
                     process_id=int(os.environ["RANK"]))
    sess = BlazeSession(mesh=make_node_data_mesh(n_shards=8))

On the CPU, ``launch.simulate.spawn_local`` starts ``P`` local processes
over ``gloo``.

The LM stack shards over a ``torch.distributed`` ``DeviceMesh`` with axes
``("data", "model")`` or ``("pod", "data", "model")``
(``distributed/sharding.py``):

* ``make_production_mesh(multi_pod=, device=)`` — the reference's 16×16
  single pod (256 ranks) or 2×16×16 two pods (512 ranks), over the default
  process group: a real cluster, or the fake group the dry run brings up
  (``launch/dryrun.py``);
* ``make_mesh(shape, names, device=)`` — any such mesh over the default
  group (the tests' (2, 4) and (2, 2) meshes);
* ``fsdp_axes(mesh)`` / ``dp_axes(mesh)`` — the parameter-sharding and
  batch-sharding axes: data, plus pod when present.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import containers as C

__all__ = ["dp_axes", "fsdp_axes", "init_distributed", "make_mesh", "make_node_data_mesh",
           "make_production_mesh", "process_count", "process_index"]


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
                     *, backend: str | None = None, device=None, **kwargs) -> bool:
    """Bring up the process group; returns whether one came up.

    Call once on every process of a multi-process launch::

        init_distributed("tcp://host0:1234", num_processes=8, process_id=rank)

    ``backend=None`` is ``"nccl"`` when ``device`` (default: the card) is
    CUDA and ``"gloo"`` on the CPU.  ``kwargs`` go to
    ``init_process_group`` (``store=`` in place of an address, ``timeout=``).
    On one process (no coordinator, no store, ``num_processes`` absent or 1)
    it is a no-op that returns ``False``, and ``make_node_data_mesh(n)``
    splits the local shards into ``n`` node rows instead.
    """
    if coordinator_address is None and "store" not in kwargs and num_processes in (None, 1):
        return False
    if backend is None:
        backend = "nccl" if torch.device("cuda" if device is None else device).type == "cuda" \
            else "gloo"
    torch.distributed.init_process_group(
        backend, init_method=coordinator_address, world_size=num_processes,
        rank=process_id, **kwargs)
    return True


def make_node_data_mesh(n_nodes: int | None = None, *, n_shards: int = 8,
                        device=None) -> C.Mesh:
    """A 2-D ``("node", "data")`` mesh over ``n_shards`` shards on
    ``device`` (the card unless the caller names another).

    Without a process group the shards are stacked on the device in
    ``n_nodes`` rows (default 1).  With a group of ``P`` processes up the
    mesh has ``P`` node rows, one a process: this one holds row ``rank``
    (``Mesh.n_local`` shards), ``n_nodes`` defaults to ``P`` and must equal
    it.  ``ValueError`` when the shards do not split evenly, when
    ``n_nodes`` is not ``P``, or when the group's backend cannot reach the
    device (``gloo`` with CUDA tensors).
    """
    procs = process_count()
    nodes = (procs if _group_up() else 1) if n_nodes is None else int(n_nodes)
    if nodes < 1 or n_shards < 1 or n_shards % nodes:
        raise ValueError(f"cannot split {n_shards} shards into {nodes} node rows")
    dev = C.resolve_device(device)
    if not _group_up():
        return C.Mesh(nodes, n_shards // nodes, dev)
    if nodes != procs:
        raise ValueError(f"{procs} processes are up, one node row a process, but "
                         f"n_nodes={nodes} was asked for")
    return C.Mesh(nodes, n_shards // nodes, dev, group=torch.distributed.group.WORLD,
                  rank=process_index(), n_ranks=procs)


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...], device=None):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the default
    process group (its world size must be the product of ``shape``), on
    ``device``'s type: the card unless the caller names another."""
    from torch.distributed.device_mesh import init_device_mesh

    if not _group_up():
        raise RuntimeError("make_mesh needs a process group: init_distributed, or "
                           "init_process_group, first")
    if process_count() != math.prod(shape):
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} ranks, "
                         f"{process_count()} are up")
    return init_device_mesh(C.resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16×16 ``("data", "model")`` (256 ranks) or 2×16×16 ``("pod", "data",
    "model")`` (512 ranks) over the default process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device=device)


def fsdp_axes(mesh) -> tuple[str, ...]:
    """Parameter-sharding (FSDP/ZeRO) axes: data, plus pod when present."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return ("pod", "data") if "pod" in names else ("data",)


def dp_axes(mesh) -> tuple[str, ...]:
    """Batch-sharding axes (the same as the FSDP axes)."""
    return fsdp_axes(mesh)
