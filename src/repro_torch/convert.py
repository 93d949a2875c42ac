"""Carry containers and LM parameters between the JAX package and the port
as numpy arrays.

The JAX package's containers hand over their arrays with ``np.asarray``
(``DistVector.data``/``.n``; ``DistHashMap.table.keys/vals/overflow`` and
``.reducer_name``); these functions build the port's containers from them
and turn the port's back into numpy, so a table built by one package can be
merged into by the other.  :func:`lm_params_from_jax` does the same for an
LM's parameters, :func:`opt_state_from_jax` for its AdamW state.  bf16
arrays travel as float32 (exact both ways).  :func:`distribute` carries a
tree of the port's tensors onto a ``DeviceMesh`` by its partition specs
(``distributed.sharding``), :func:`gather` brings it back whole.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.containers import (
    DistHashMap,
    DistVector,
    HashTable,
    resolve_device,
)


def _tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":  # numpy has no bf16; torch.from_numpy refuses it
        return torch.from_numpy(x.astype(np.float32)).to(device, torch.bfloat16)
    # A copy: arrays handed over by JAX are read-only, torch tensors are not.
    return torch.from_numpy(np.array(x)).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def dist_vector(data, n: int, device=None) -> DistVector:
    """A ``DistVector`` from its padded data ``[S * per, ...]`` and true
    length ``n``."""
    return DistVector(_tensor(data, resolve_device(device)), int(n))


def dist_hashmap(keys, vals, overflow, reducer_name: str, device=None) -> DistHashMap:
    """A ``DistHashMap`` from ``keys [S, C]``, ``vals [S, C, ...]``,
    ``overflow [S]`` and the reducer's name."""
    dev = resolve_device(device)
    table = HashTable(
        _tensor(np.asarray(keys, np.int32), dev),
        _tensor(vals, dev),
        _tensor(np.asarray(overflow, np.int32), dev),
    )
    return DistHashMap(table, reducer_name=reducer_name)


def to_numpy(container):
    """``(data, n)`` for a ``DistVector``; ``(keys, vals, overflow,
    reducer_name)`` for a ``DistHashMap``."""
    if isinstance(container, DistVector):
        return _numpy(container.data), container.n
    if isinstance(container, DistHashMap):
        t = container.table
        return _numpy(t.keys), _numpy(t.vals), _numpy(t.overflow), container.reducer_name
    raise TypeError(f"cannot convert {type(container).__name__}")


def lm_params_from_jax(params_np, cfg, device=None) -> dict:
    """The port's LM parameters from ``repro.models.model.init``'s pytree,
    its leaves as numpy arrays (``jax.tree.map(np.asarray, params)``).

    The JAX pytree stacks each stage slot's parameters on a leading
    ``[n_stages]`` axis; the port keeps one dict per layer, in the same order
    (stage by stage, slot by slot, then the tail).  A ``SHARED_ATTN`` slot
    has no stacked entry in JAX (its block is ``params["shared_attn"]``):
    every such layer of the port refers to the one converted dict.  Weights
    keep JAX's ``[d_in, d_out]`` layout: the port computes ``x @ W`` as JAX
    does.  An MoE layer's ``moe`` dict carries over as every other block's:
    ``router [n_stages, d, E]`` f32, ``w_gate``/``w_up [n_stages, E, d,
    ff]`` and ``w_down [n_stages, E, ff, d]`` become one layer's ``[d, E]``,
    ``[E, d, ff]`` and ``[E, ff, d]``.
    """
    from repro_torch.configs.base import SHARED_ATTN
    from repro_torch.models.model import layer_kinds

    layer_kinds(cfg)  # raises for an unknown block kind
    dev = resolve_device(device)

    def tree(x, stage=None):
        if isinstance(x, dict):
            return {k: tree(v, stage) for k, v in x.items()}
        x = np.asarray(x)
        return _tensor(x if stage is None else x[stage], dev)

    out = {}
    if "shared_attn" in params_np:
        out["shared_attn"] = tree(params_np["shared_attn"])
    layers = [out["shared_attn"] if kind == SHARED_ATTN
              else tree(params_np["stages"][f"slot{j}"], i)
              for i in range(cfg.n_stages) for j, kind in enumerate(cfg.stage_pattern)]
    layers += [tree(p) for p in params_np["tail"]]
    out.update(layers=layers, embed=tree(params_np["embed"]),
               final_norm=tree(params_np["final_norm"]))
    if "lm_head" in params_np:
        out["lm_head"] = tree(params_np["lm_head"])
    return out


def opt_state_from_jax(state_np, cfg, device=None) -> dict:
    """The port's AdamW state (``optim.adamw.AdamW``: ``{"m", "v", "step"}``)
    from ``repro.optim.adamw.AdamW``'s, its leaves as numpy arrays.  The
    moments are trees shaped like the parameters and convert as
    :func:`lm_params_from_jax` converts those (stacked stage slots to one
    dict per layer; the shared block once, every ``SHARED_ATTN`` layer
    referring to it), in their own dtype; ``step`` becomes a 0-d int32
    tensor."""
    dev = resolve_device(device)
    return {"m": lm_params_from_jax(state_np["m"], cfg, dev),
            "v": lm_params_from_jax(state_np["v"], cfg, dev),
            "step": torch.tensor(int(np.asarray(state_np["step"])), dtype=torch.int32,
                                 device=dev)}


def distribute(tree, specs, mesh):
    """Every tensor of ``tree`` as a ``DTensor`` on ``mesh`` with its spec's
    placements (``specs`` parallel to ``tree``: ``sharding.param_pspecs``,
    ``opt_pspecs``, ``batch_pspecs``, ``cache_pspecs``), each rank keeping
    its own slice of the full tensor it holds (no communication: every rank
    must hold the same tree).  Sharing is kept (zamba2's shared block stays
    one dict)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding as SH

    names = tuple(mesh.mesh_dim_names)
    return SH._map(lambda _p, t, s: distribute_tensor(t, mesh, SH.placements(s, names),
                                                      src_data_rank=None), tree, specs)


def gather(tree):
    """Every ``DTensor`` of ``tree`` whole on every rank (``full_tensor``);
    other leaves as they are."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as SH

    return SH._map(lambda _p, t: t.full_tensor() if isinstance(t, DTensor) else t, tree)
