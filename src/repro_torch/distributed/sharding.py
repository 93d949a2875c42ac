"""Sharding policy: parameter / optimizer / batch / cache partition specs,
and their placements on a ``torch.distributed`` ``DeviceMesh`` (the port of
``repro/distributed/sharding.py``).

Scheme (the reference's, unchanged):

* parameters — FSDP-shard the "reduction" dim over the data(+pod) axes and
  TP-shard the "parallel" dim over model: wq/wk/wv/w_gate/w_up ``(fsdp,
  model)``, wo/w_down ``(model, fsdp)``, embed ``(model, fsdp)`` (vocab over
  model), MoE experts ``(None, fsdp, model)``;
* optimizer state mirrors parameters;
* batch — tokens over the dp axes;
* caches — batch over dp when divisible, else sequence over dp; KV heads
  over model when divisible, else sequence takes model too (prefill) or
  decode shards ``d_head`` over model.

Every axis application is guarded by :func:`_fit`: a dim only takes a mesh
axis whose size divides it, so the same policy serves full configs, reduced
test configs and both production meshes.

A spec is a :class:`P`: one entry per dim, each ``None``, an axis name, or
a tuple of names.  The port keeps one parameter dict per layer (the
reference stacks a stage slot's layers on a leading dim), so a spec here is
the reference leaf's spec without its leading ``None``.  :class:`MeshInfo`
needs only the mesh's axis names and sizes, so the policy runs without a
process group; :func:`named` turns specs into ``DTensor`` placements (a
tuple such as ``("pod", "data")`` on one dim is ``Shard(dim)`` on both mesh
dims, pod outermost), and :func:`shard_like` makes each rank's local shards
directly (no full tensor); ``convert.distribute`` places a whole tree on a
``DeviceMesh`` and ``convert.gather`` brings it back.

:func:`constrain` is the counterpart of ``with_sharding_constraint``: on a
plain tensor it returns its argument, so the unsharded path is unchanged;
on a ``DTensor`` it redistributes to the fitted placements.
:func:`run_local` runs a function on each rank's local shards through
``local_map``, for the kernels and the steps DTensor has no rule for.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig

#: The data-parallel axes the model code names (``("pod", "data")``, fitted
#: to the mesh, as the reference's constraints name them).
DP = ("pod", "data")
MODEL = "model"


class P(tuple):
    """A partition spec: one entry per dim, each ``None``, an axis name or a
    tuple of axis names (the counterpart of ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (tuple(e) if isinstance(e, list) else e
                                     for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


@dataclasses.dataclass(frozen=True)
class _AxisView:
    """A mesh's axis sizes by name and its axis names, in order."""

    shape: dict
    axis_names: tuple


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """The policy's view of a mesh: ``mesh`` is any object with ``shape``
    (axis name → size) and ``axis_names``; ``device_mesh`` the
    ``DeviceMesh`` behind it, if any."""

    mesh: object
    fsdp: tuple[str, ...]  # ("data",) or ("pod", "data")
    model: str = MODEL
    device_mesh: object = None

    @property
    def model_size(self) -> int:
        return self.mesh.shape[self.model]

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.fsdp)

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            return self.mesh.shape[axes]
        return math.prod(self.mesh.shape[a] for a in axes)


def _axis_view(mesh):
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh: shape is a tuple of sizes
        return _AxisView(dict(zip(names, mesh.shape)), tuple(names))
    return mesh


def make_mesh_info(mesh) -> MeshInfo:
    """``MeshInfo`` of a ``DeviceMesh`` or of any object with ``shape`` (name
    → size) and ``axis_names``."""
    view = _axis_view(mesh)
    fsdp = ("pod", "data") if "pod" in view.axis_names else ("data",)
    return MeshInfo(mesh=view, fsdp=fsdp,
                    device_mesh=mesh if view is not mesh else None)


def _fit_axes(spec_axes, shape, names, sizes) -> list:
    out = []
    for dim, ax in zip(shape, spec_axes):
        if ax is None:
            out.append(None)
            continue
        axes = tuple(a for a in ((ax,) if isinstance(ax, str) else ax) if a in names)
        size = math.prod(sizes[a] for a in axes)
        if axes and size > 1 and dim % size == 0:
            out.append(axes[0] if len(axes) == 1 else axes)
        else:
            out.append(None)
    return out


def _fit(spec_axes: tuple, shape: tuple, mi: MeshInfo) -> P:
    """Drop axes that don't divide their dim (or don't exist in the mesh)."""
    return P(*_fit_axes(spec_axes, shape, mi.mesh.axis_names, mi.mesh.shape))


# ---------------------------------------------------------------------------
# Trees (dicts, lists, tuples and NamedTuples of tensors or specs)
# ---------------------------------------------------------------------------


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, P)) or x is None


def _map(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over parallel trees, keeping sharing:
    a dict met twice (zamba2's shared block) maps once, and its image
    appears at each place."""
    memo: dict[int, object] = {}

    def go(x, others, path):
        if not _is_leaf(x) and id(x) in memo:
            return memo[id(x)]
        if _is_leaf(x):
            return fn(path, x, *others)
        if isinstance(x, dict):
            out = {k: go(v, [o[k] for o in others], path + (str(k),)) for k, v in x.items()}
        elif isinstance(x, tuple) and hasattr(x, "_fields"):  # NamedTuple
            out = type(x)(*(go(v, [o[i] for o in others], path + (x._fields[i],))
                            for i, v in enumerate(x)))
        elif isinstance(x, (list, tuple)):
            out = type(x)(go(v, [o[i] for o in others], path + (str(i),))
                          for i, v in enumerate(x))
        else:
            raise TypeError(f"unexpected {type(x).__name__} in a tree")
        memo[id(x)] = out
        return out

    return go(tree, list(rest), tuple(path))


def leaves(tree) -> list:
    """The tree's leaves, each distinct dict once (zamba2's shared block)."""
    out = []
    _map(lambda _p, x: out.append(x), tree)
    return out


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

_COL = "col"  # (fsdp, model): d_in -> fsdp, d_out -> model
_ROW = "row"  # (model, fsdp)

_PARAM_RULES: dict[tuple[str, str], str] = {
    # (parent, key) -> layout; "*" matches any parent
    ("*", "embed"): "embed",
    ("*", "lm_head"): _COL,
    ("attn", "wq"): _COL,
    ("attn", "wk"): _COL,
    ("attn", "wv"): _COL,
    ("attn", "wo"): _ROW,
    ("mlp", "w_gate"): _COL,
    ("mlp", "w_up"): _COL,
    ("mlp", "w_down"): _ROW,
    ("moe", "router"): "router",
    ("moe", "w_gate"): "expert_col",
    ("moe", "w_up"): "expert_col",
    ("moe", "w_down"): "expert_row",
    ("mamba", "in_proj"): _COL,
    ("mamba", "out_proj"): _ROW,
    ("mamba", "conv_w"): "conv",
    ("mamba", "conv_b"): "vec_model",
    ("tm", "wr"): _COL,
    ("tm", "wk"): _COL,
    ("tm", "wv"): _COL,
    ("tm", "wg"): _COL,
    ("tm", "wo"): _ROW,
    ("tm", "mix_w1"): "col_rep",
    ("cm", "wk"): _COL,
    ("cm", "wv"): _ROW,
    ("cm", "wr"): _COL,
}


def param_pspecs(cfg: ArchConfig, params, mi: MeshInfo, *, serving: bool = False):
    """A spec tree parallel to ``models.model.init``'s parameters (one dict
    per layer; the shared block's dict once, wherever it appears).

    ``serving=True`` drops the FSDP dim (parameters replicated over data,
    TP over model): a decode step then never all-gathers weights."""
    del cfg
    fs, md = (None, mi.model) if serving else (mi.fsdp, mi.model)
    layouts = {"embed": (md, fs), _COL: (fs, md), _ROW: (md, fs), "router": (fs, None),
               "expert_col": (None, fs, md), "expert_row": (None, md, fs),
               "conv": (None, md), "vec_model": (md,), "col_rep": (fs, None)}

    def one(path, leaf):
        key = path[-1] if path else ""
        parent = path[-2] if len(path) > 1 else ""
        rule = _PARAM_RULES.get((parent, key)) or _PARAM_RULES.get(("*", key))
        shape = tuple(leaf.shape)
        axes = layouts.get(rule, ())[: len(shape)]
        return _fit(tuple(axes) + (None,) * (len(shape) - len(axes)), shape, mi)

    return _map(one, params)


def opt_pspecs(param_specs, opt_state):
    """Optimizer moments mirror the parameters' specs; every other leaf (the
    step) is replicated."""
    return {k: (param_specs if k in ("m", "v", "residual")
                else _map(lambda _p, x: P(*(None,) * len(x.shape)), v))
            for k, v in opt_state.items()}


# ---------------------------------------------------------------------------
# Batch / cache
# ---------------------------------------------------------------------------


def batch_pspecs(cfg: ArchConfig, batch, mi: MeshInfo):
    """Every leaf (anything with ``shape``) sharded on dim 0 over the dp axes."""
    del cfg
    return _map(lambda _p, x: _fit((mi.fsdp,) + (None,) * (len(x.shape) - 1),
                                   tuple(x.shape), mi), batch)


def cache_pspecs(cfg: ArchConfig, batch: int, max_len: int, mi: MeshInfo,
                 kind: str = "decode") -> list:
    """Specs parallel to ``models.model.make_caches(cfg, batch, max_len)``:
    one ``KVCache``, ``MambaCache`` or ``RWKVCache`` of specs per layer.

    KV layout (when kv heads don't divide the model axis): decode shards
    ``d_head`` (the cache update and the PV product stay device-local; only
    the per-token logits' partial sums cross the wire); prefill shards the
    sequence, gathered before the attention kernel."""
    from repro_torch.models import attention as A
    from repro_torch.models import rwkv as RW
    from repro_torch.models import ssm as SSM
    from repro_torch.models.model import _ATTN_KINDS, MAMBA2, layer_kinds

    fs, md = mi.fsdp, mi.model
    b_ok = batch % mi.dp_size == 0
    heads_ok = cfg.n_kv_heads % mi.model_size == 0
    dh_ok = cfg.d_head % mi.model_size == 0
    b_ax = fs if b_ok else None
    use_dh = (not heads_ok) and dh_ok and kind == "decode"
    s_axes = []  # sequence picks up whatever batch/heads leave unused
    if not b_ok:
        s_axes.extend(fs)
    if not heads_ok and not use_dh:
        s_axes.append(md)
    s_ax = tuple(s_axes) if s_axes else None
    h_ax = md if heads_ok else None
    dh_ax = md if use_dh else None

    def block(kind_):
        if kind_ in _ATTN_KINDS:
            shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
            spec = _fit((b_ax, s_ax, h_ax, dh_ax), shape, mi)
            return A.KVCache(k=spec, v=spec)
        if kind_ == MAMBA2:
            _, h, conv_dim = SSM._dims(cfg)
            return SSM.MambaCache(
                conv=_fit((b_ax, None, md), (batch, cfg.conv_width - 1, conv_dim), mi),
                h=_fit((b_ax, md, None, None),
                       (batch, h, cfg.ssm_head_dim, cfg.ssm_state), mi))
        d = cfg.d_model
        h = d // cfg.rwkv_head_dim
        return RW.RWKVCache(
            shift_tm=_fit((b_ax, md), (batch, d), mi),
            shift_cm=_fit((b_ax, md), (batch, d), mi),
            state=_fit((b_ax, md, None, None),
                       (batch, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim), mi))

    return [block(k) for k in layer_kinds(cfg)]


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------


def placements(spec, axis_names) -> tuple:
    """The ``DTensor`` placements of ``spec`` on a mesh with these axis
    names: ``Shard(dim)`` on each mesh dim a tensor dim names (several
    names on one dim in mesh order, the first outermost), ``Replicate()``
    on the others."""
    out = [Replicate()] * len(axis_names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} must follow the "
                             f"mesh's order {axis_names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} names mesh axis {axis_names[i]!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


def named(tree, mi: MeshInfo):
    """Spec tree -> placements tree (a tuple of placements per leaf)."""
    names = tuple(mi.mesh.axis_names)
    return _map(lambda _p, s: placements(s, names), tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where one tensor lives: a ``DeviceMesh`` and a :class:`P` over its
    axis names (the counterpart of ``jax.sharding.NamedSharding``).  A
    ``shardings`` tree of ``CheckpointManager.restore`` holds it as one
    leaf."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, tuple(self.mesh.mesh_dim_names))


def _mesh_axes(mesh):
    names = tuple(mesh.mesh_dim_names)
    return names, dict(zip(names, mesh.shape))


def fitted_placements(mesh, shape, axes) -> tuple:
    """Placements of ``axes`` (one entry per dim) on ``mesh``, fitted to
    ``shape`` as :func:`constrain` fits them."""
    names, sizes = _mesh_axes(mesh)
    return placements(_fit_axes(axes, shape, names, sizes), names)


def constrain(x, *axes):
    """Redistribute a ``DTensor`` to the placements of ``axes`` (one entry
    per dim: None, an axis name, or a tuple of names), each axis kept only
    where it exists and divides its dim.  A plain tensor is returned as it
    is, so model code annotates unconditionally; so is a ``DTensor`` when
    every axis drops out (as the reference constrains nothing then)."""
    if not isinstance(x, DTensor):
        return x
    names, sizes = _mesh_axes(x.device_mesh)
    fitted = _fit_axes(axes, tuple(x.shape), names, sizes)
    if all(f is None for f in fitted):
        return x
    target = placements(fitted, names)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def relayout(x, *axes):
    """A ``DTensor`` redistributed to exactly the fitted placements of
    ``axes`` (dims and mesh axes not named are whole/replicated); a plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    target = fitted_placements(x.device_mesh, tuple(x.shape), axes)
    return x if tuple(x.placements) == target else x.redistribute(x.device_mesh, target)


def split_heads(t, n: int, size: int):
    """``[..., n·size]`` → ``[..., n, size]``.  A ``DTensor`` first takes
    (dp on dim 0, the middle dims whole, the last over model where ``n``
    divides by it, else whole): a view cannot split a dim sharded finer
    than its heads."""
    if isinstance(t, DTensor):
        i = axis_index(t.device_mesh, MODEL)
        m = 1 if i is None else t.device_mesh.shape[i]
        t = relayout(t, DP, *(None,) * (t.ndim - 2), MODEL if n % m == 0 else None)
    return t.unflatten(-1, (n, size))


def merge_last(t, n: int):
    """``[..., a, b]`` → ``[..., a·b]`` (``n = 2`` dims merged into one).  On a
    ``DTensor`` the merged dims after the first are gathered first (a view
    keeps only the first of them sharded), and the result is pinned to the
    layout the merge gives it, so the backward splits the gradient from a
    layout a view can split (whatever layout the next op's gradient would
    arrive in otherwise)."""
    if not isinstance(t, DTensor):
        return t.reshape(*t.shape[:-n], -1)
    inner = range(t.ndim - n + 1, t.ndim)  # merged dims a view cannot keep sharded
    whole = tuple(Replicate() if isinstance(p, Shard) and p.dim % t.ndim in inner else p
                  for p in t.placements)
    if whole != tuple(t.placements):
        t = t.redistribute(t.device_mesh, whole)
    out = t.reshape(*t.shape[:-n], -1)
    return out.redistribute(out.device_mesh, out.placements)


_MIXING = threading.local()  # how deep this thread is in mixing() contexts


@contextlib.contextmanager
def mixing(x):
    """A context in which plain tensors (positions, masks, ``arange``) mix
    with ``x``'s ``DTensor``s as replicated ones (``implicit_replication``)
    when ``x`` is a ``DTensor``; nothing otherwise.  Nested contexts leave
    it on until the outermost exits (``implicit_replication`` itself turns
    it off on any exit).  The setting is per thread: a backward that runs
    on another thread (the card's) must not need it."""
    depth = getattr(_MIXING, "depth", 0)
    if not depth and not isinstance(x, DTensor):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _MIXING.depth = depth + 1
    try:
        with implicit_replication() if not depth else contextlib.nullcontext():
            yield
    finally:
        _MIXING.depth = depth


def replicated(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` (the same on every rank) as a replicated ``DTensor`` on
    ``like``'s mesh when ``like`` is a ``DTensor``; else ``t``."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def axis_index(mesh, name: str) -> int | None:
    """The index of mesh axis ``name`` (None when the mesh has no such axis)."""
    names = tuple(mesh.mesh_dim_names)
    return names.index(name) if name in names else None


def shard_offset(x: DTensor, dim: int) -> int:
    """Where this rank's shard of ``x`` starts along ``dim`` (even shards;
    0 when ``dim`` is not sharded)."""
    coord = x.device_mesh.get_coordinate()
    off, n = 0, 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim:
            off = off * x.device_mesh.shape[i] + coord[i]
            n *= x.device_mesh.shape[i]
    return off * (x.shape[dim] // n)


def run_local(fn: Callable, out_placements, args, in_placements):
    """``fn`` on each rank's local shards (``local_map``): every ``DTensor``
    argument is first redistributed to its entry of ``in_placements`` (None
    for an argument that is not a ``DTensor``), and each output becomes a
    ``DTensor`` with its entry of ``out_placements``.

    Differentiable: an input whole on a mesh dim over which the outputs are
    split (sharded or partial sums) gets each rank's share of its gradient
    there, so its gradient is a partial sum on that dim.  So on a mesh dim
    where one output is split, every output must be (an output each rank
    computes whole there would have its gradient summed once a rank)."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    moved = []
    for a, pl in zip(args, in_placements):
        if isinstance(a, DTensor) and tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, tuple(pl))
        moved.append(a)
    if out_placements and isinstance(out_placements[0], Placement):
        out_placements = (tuple(out_placements),)  # one output
    split = [any(not isinstance(o[i], Replicate) for o in out_placements)
             for i in range(mesh.ndim)]
    ins = tuple(tuple(pl) if isinstance(a, DTensor) else None
                for a, pl in zip(moved, in_placements))
    grads = tuple(None if pl is None else tuple(
        Partial() if split[i] and isinstance(p, Replicate) else p for i, p in enumerate(pl))
        for pl in ins)
    return local_map(fn, out_placements=out_placements, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh)(*moved)


def write_into(dst, src) -> None:
    """``dst.copy_(src)`` in place, for a ``DTensor`` destination too (``src``
    redistributed to ``dst``'s placements first, then each rank copies its
    shard)."""
    if isinstance(dst, DTensor):
        if not isinstance(src, DTensor):
            raise TypeError("write_into: a DTensor destination needs a DTensor source")
        if tuple(src.placements) != tuple(dst.placements):
            src = src.redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)


def is_sharded_placements(placements_, dim: int) -> bool:
    """Whether placements shard tensor dim ``dim`` (a non-negative index)."""
    return any(isinstance(p, Shard) and p.dim == dim for p in placements_)


def is_sharded(x, dim: int) -> bool:
    """Whether ``x`` is a ``DTensor`` sharded along ``dim``."""
    return isinstance(x, DTensor) and is_sharded_placements(x.placements, dim % x.ndim)


# ---------------------------------------------------------------------------
# Carrying trees onto and off a mesh
# ---------------------------------------------------------------------------


def reshard(tree, specs):
    """Every ``DTensor`` of ``tree`` redistributed to its spec's placements
    (a prefill's caches to a decode step's layout, say)."""
    def one(_p, t, s):
        pl = placements(s, tuple(t.device_mesh.mesh_dim_names))
        return t if tuple(t.placements) == pl else t.redistribute(t.device_mesh, pl)

    return _map(one, tree, specs)


def local_shape(shape, placements_, mesh) -> tuple:
    """The local shape of an evenly sharded tensor."""
    out = list(shape)
    for i, p in enumerate(placements_):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.shape[i]
    return tuple(out)


def shard_like(tree, specs, mesh, make: Callable):
    """A ``DTensor`` tree shaped like ``tree`` (leaves with ``shape`` and
    ``dtype``; fake or meta tensors serve), each rank's local shard made by
    ``make(local_shape, dtype)`` with no full tensor anywhere."""
    names = tuple(mesh.mesh_dim_names)

    def one(_p, t, s):
        pl = placements(s, names)
        local = make(local_shape(tuple(t.shape), pl, mesh), t.dtype)
        glob = tuple(t.shape)
        stride = tuple(math.prod(glob[i + 1:]) for i in range(len(glob)))
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=torch.Size(glob),
                                  stride=stride)

    return _map(one, tree, specs)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tree's tensors (each distinct
    tensor once)."""
    seen, total = set(), 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    return total
