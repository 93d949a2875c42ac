"""The port's sharding policy (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), on abstract meshes.

Both policies run over a ``FakeMesh`` (axis sizes by name, no devices, no
process group), as ``tests/test_sharding_policy.py`` runs the reference's:
the single pod (16 data × 16 model) and two pods (2 × 16 × 16).  For all
ten architectures at full size, with ``serving`` off and on, every port
tensor's spec must equal its reference leaf's spec without the leading
stage dim (the reference stacks a stage slot's layers; the port keeps one
dict per layer): the port's layer ``i`` of the staged layers is slot ``i %
len(stage_pattern)`` of ``stages``, a tail layer its ``tail`` entry, the
shared block ``shared_attn``.  The same holds for the AdamW moments
(``opt_pspecs``) and for the caches (``cache_pspecs``) in the three cases
of ``tests/test_sharding_policy.py``.  The reference's own checks are
mirrored: every spec divides its dims, every tensor of 8 M elements or more
is sharded, serving drops the data axis.  The port's parameters are fake
tensors (``launch.dryrun.param_shapes``): nothing is allocated.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import get_arch as jget_arch
from repro.distributed import sharding as JSH
from repro.models import model as JM
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.configs.base import SHARED_ATTN, get_arch, list_archs
from repro_torch.distributed import sharding as SH
from repro_torch.launch.dryrun import param_shapes
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW


@dataclasses.dataclass(frozen=True)
class FakeMesh:
    shape: dict
    axis_names: tuple


MESHES = {
    "pod16x16": FakeMesh({"data": 16, "model": 16}, ("data", "model")),
    "pod2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model")),
}


def _mis(mesh_name):
    mesh = MESHES[mesh_name]
    return JSH.make_mesh_info(mesh), SH.make_mesh_info(mesh)


@functools.cache
def _shapes(arch):
    return param_shapes(get_arch(arch)), jax.eval_shape(
        lambda k: JM.init(k, jget_arch(arch)), jax.random.PRNGKey(0))


def _ref_specs(tree) -> dict:
    """The reference's spec tree by leaf path (tuple of key strings)."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(JSH._path_keys(p)): tuple(s) for p, s in flat}


def _ref_path(cfg, path):
    """The reference leaf of the port tensor at ``path``, and whether that
    leaf is stacked over the stages."""
    if path[0] != "layers":
        return path, False
    i = int(path[1])
    n_slots = len(cfg.stage_pattern)
    staged = cfg.n_stages * n_slots
    if i >= staged:
        return ("tail", str(i - staged)) + path[2:], False
    if cfg.stage_pattern[i % n_slots] == SHARED_ATTN:
        return ("shared_attn",) + path[2:], False
    return ("stages", f"slot{i % n_slots}") + path[2:], True


def _port_specs(tree) -> dict:
    out = {}
    SH._map(lambda path, s: out.__setitem__(path, s), tree)
    return out


def _assert_same(cfg, port, ref):
    seen = set()
    for path, spec in port.items():
        rpath, stacked = _ref_path(cfg, path)
        want = ref[rpath]
        if stacked:
            assert want[0] is None, (path, want)
            want = want[1:]
        assert tuple(spec) == want, (cfg.name, path, spec, want)
        seen.add(rpath)
    assert seen == set(ref), set(ref) ^ seen  # every reference leaf has a port tensor


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_opt_specs_equal_the_reference(arch, mesh_name, serving):
    cfg = get_arch(arch)
    port_shapes, ref_shapes = _shapes(arch)
    jmi, mi = _mis(mesh_name)
    port = SH.param_pspecs(cfg, port_shapes, mi, serving=serving)
    ref = JSH.param_pspecs(jget_arch(arch), ref_shapes, jmi, serving=serving)
    _assert_same(cfg, _port_specs(port), _ref_specs(ref))

    # every shared-block layer reads the one spec dict, as it reads one block
    shared = [i for i, k in enumerate(M.layer_kinds(cfg)) if k == SHARED_ATTN]
    assert all(port["layers"][i] is port["shared_attn"] for i in shared)

    with FakeTensorMode(allow_non_fake_inputs=True):  # shapes only: allocate nothing
        ostate = AdamW().init(port_shapes)
    ospecs = SH.opt_pspecs(port, ostate)
    jostate = jax.eval_shape(JAdamW().init, ref_shapes)
    jospecs = _ref_specs(JSH.opt_pspecs(ref, jostate))
    for moment in ("m", "v"):
        _assert_same(cfg, _port_specs(ospecs[moment]),
                     {k[1:]: v for k, v in jospecs.items() if k[0] == moment})
    assert tuple(ospecs["step"]) == jospecs[("step",)] == ()


def _axis_size(mi, ax):
    if ax is None:
        return 1
    return mi.axis_size(ax)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_divide_and_shard_the_big_tensors(arch, mesh_name):
    """The reference's own checks, on the port's per-layer tensors."""
    cfg = get_arch(arch)
    port_shapes, _ = _shapes(arch)
    _, mi = _mis(mesh_name)
    specs = SH.param_pspecs(cfg, port_shapes, mi)
    n_sharded = 0
    for t, spec in zip(SH.leaves(port_shapes), SH.leaves(specs)):
        assert len(spec) == t.ndim
        for dim, ax in zip(t.shape, spec):
            assert dim % _axis_size(mi, ax) == 0, (arch, t.shape, spec)
            n_sharded += _axis_size(mi, ax) > 1
        if t.numel() >= 8_000_000:
            assert any(ax is not None for ax in spec), (arch, t.shape, spec)
    assert n_sharded > 0


CACHE_CASES = [("decode_32k", 128, 32768, "decode"), ("prefill_32k", 32, 32768, "prefill"),
               ("long_500k", 1, 524288, "decode")]


@pytest.mark.parametrize("case", CACHE_CASES, ids=[c[0] for c in CACHE_CASES])
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_equal_the_reference(arch, case):
    _, batch, seqlen, kind = case
    cfg = get_arch(arch)
    jmi, mi = _mis("pod16x16")
    port = SH.cache_pspecs(cfg, batch, seqlen, mi, kind=kind)
    ref = JSH.cache_pspecs(jget_arch(arch), batch, seqlen, jmi, kind=kind)
    kinds = M.layer_kinds(cfg)
    assert len(port) == len(kinds)
    n_slots, staged = len(cfg.stage_pattern), cfg.n_stages * len(cfg.stage_pattern)
    for i, spec in enumerate(port):
        if i < staged:
            want = [JP(*tuple(s)[1:]) for s in ref["stages"][i % n_slots]]
        else:
            want = list(ref["tail"][i - staged])
        assert type(spec).__name__ == type(ref["tail"][0] if i >= staged
                                           else ref["stages"][i % n_slots]).__name__
        assert [tuple(s) for s in spec] == [tuple(w) for w in want], (arch, i, spec, want)
    caches = _cache_shapes(cfg, batch, seqlen)
    for c, spec in zip(caches, port):
        for t, s in zip(c, spec):
            for dim, ax in zip(t, s):
                assert dim % _axis_size(mi, ax) == 0, (arch, t, s)


def _cache_shapes(cfg, batch, seqlen):
    with FakeTensorMode():
        return [[tuple(t.shape) for t in c] for c in M.make_caches(cfg, batch, seqlen, "cpu")]


def test_serving_policy_drops_fsdp():
    cfg = get_arch("gemma2-9b")
    _, mi = _mis("pod16x16")
    port_shapes, _ = _shapes("gemma2-9b")

    def has_data(spec):
        return any(a == "data" or (isinstance(a, tuple) and "data" in a)
                   for a in spec if a is not None)

    assert any(has_data(s) for s in SH.leaves(SH.param_pspecs(cfg, port_shapes, mi)))
    assert not any(has_data(s) for s in SH.leaves(
        SH.param_pspecs(cfg, port_shapes, mi, serving=True)))


def test_named_and_constrain():
    """Specs to placements: one axis a mesh dim, a tuple of axes on one dim
    ``Shard(dim)`` on each of them (pod outermost); ``constrain`` of a plain
    tensor is that tensor."""
    _, mi = _mis("pod2x16x16")
    got = SH.named({"w": SH.P(("pod", "data"), "model"), "b": SH.P(None)}, mi)
    assert got["w"] == (Shard(0), Shard(0), Shard(1))
    assert got["b"] == (Replicate(), Replicate(), Replicate())
    with pytest.raises(ValueError, match="order"):
        SH.placements(SH.P(("data", "pod")), ("pod", "data", "model"))
    x = torch.randn(4, 8, 16)
    assert SH.constrain(x, SH.DP, SH.MODEL, None) is x
    assert SH.relayout(x, SH.DP) is x


def test_fit_drops_axes_that_do_not_divide_or_exist():
    _, mi = _mis("pod16x16")
    assert SH._fit((("pod", "data"), "model", "model"), (32, 8, 48), mi) == \
        SH.P("data", None, "model")
    assert SH._fit((None, ("data", "model")), (3, 512), mi) == SH.P(None, ("data", "model"))
