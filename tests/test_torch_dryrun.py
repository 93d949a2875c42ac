"""The port's production-mesh dry run (``repro_torch.launch.dryrun``) against
the reference's accounting, on the CPU.

The CLI runs in subprocesses (so no fake process group is left in the test
worker), one full-width cell per block family on the single pod (16 data ×
16 model, a fake group of 256 ranks): qwen3-0.6b ``train_4k`` (attention,
the train step with AdamW), mixtral-8x22b ``decode_32k`` (MoE, FSDP kept:
its model-axis shard is over 12 GiB), zamba2-7b ``prefill_32k`` (Mamba-2
and the shared block) and rwkv6-1.6b ``long_500k`` (RWKV-6, batch 1: the
caches sharded over the sequence).  Each cell must be ``ok``; its
per-device parameter bytes must equal the sum of the local shards the
reference's ``param_pspecs`` implies (its serving rule too); ``params`` and
``analytic_flops`` must equal the reference's ``param_counts`` and
``analytic_flops`` (computed in a subprocess: importing
``repro.launch.dryrun`` forces 512 host devices); a train cell must show
all-gather and reduce-scatter bytes (FSDP's gathers and the gradients'
reduce-scatters).  A failed cell makes the CLI exit 1.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import pytest

from repro.configs.base import get_arch as jget_arch
from repro.distributed import sharding as JSH
from repro.models import model as JM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [("qwen3-0.6b", "train_4k"), ("mixtral-8x22b", "decode_32k"),
         ("zamba2-7b", "prefill_32k"), ("rwkv6-1.6b", "long_500k")]

_REF = """
import json
from repro.configs.base import SHAPES, get_arch
from repro.launch import dryrun as D
out = {}
for arch, shape in %r:
    cfg = get_arch(arch)
    out[arch + "/" + shape] = {"params": D.param_counts(cfg),
                               "analytic_flops": D.analytic_flops(cfg, SHAPES[shape])}
print(json.dumps(out))
""" % (CELLS,)


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The four cells' records (the CLI, one subprocess a cell, in parallel)
    and the reference's counts."""
    out = tmp_path_factory.mktemp("dryrun")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--multi-pod", "single", "--device", "cpu", "--out", str(out)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, shape in CELLS]
    ref = subprocess.run([sys.executable, "-c", _REF], capture_output=True, text=True,
                         env=_env(), timeout=600)
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stdout[-2000:] + stderr[-3000:]
    assert ref.returncode == 0, ref.stderr[-3000:]
    recs = {}
    for arch, shape in CELLS:
        with open(out / f"{arch}_{shape}_pod16x16_baseline.json") as f:
            recs[arch + "/" + shape] = json.load(f)
    return recs, json.loads(ref.stdout.strip().splitlines()[-1])


@dataclasses.dataclass(frozen=True)
class FakeMesh:
    shape: dict
    axis_names: tuple


def _ref_param_bytes(arch, shape_name):
    """Bytes of one device's shards under the reference's ``param_pspecs``
    (its decode-serving rule applied) on the single pod."""
    from repro.configs.base import SHAPES

    cfg = jget_arch(arch)
    mi = JSH.make_mesh_info(FakeMesh({"data": 16, "model": 16}, ("data", "model")))
    shapes = jax.eval_shape(lambda k: JM.init(k, cfg), jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(shapes)
    total = sum(math.prod(x.shape) * x.dtype.itemsize for x in leaves)
    serving = SHAPES[shape_name].kind == "decode" and total / mi.model_size < 12 * 2**30
    specs = jax.tree.leaves(JSH.param_pspecs(cfg, shapes, mi, serving=serving),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return sum(math.prod(x.shape) * x.dtype.itemsize
               // math.prod(mi.axis_size(a) for a in tuple(s)) for x, s in zip(leaves, specs))


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_dryrun_cell_matches_the_reference_accounting(records, cell):
    recs, ref = records
    key = "/".join(cell)
    rec = recs[key]
    assert rec["ok"], rec.get("error")
    assert rec["param_bytes_per_device"] == _ref_param_bytes(*cell)
    assert rec["params"] == ref[key]["params"]
    assert rec["analytic_flops"] == ref[key]["analytic_flops"]
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes_per_device"]
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["cost"]["bytes_accessed_per_device"] is None
    if cell[1] == "train_4k":
        assert rec["collectives"]["all-gather"] > 0
        assert rec["collectives"]["reduce-scatter"] > 0
        assert rec["moment_dtype"] == "float32" and not rec["serving"]
    assert rec["collectives"]["n_collective_ops"] > 0


def test_dryrun_defaults_to_the_card_and_raises_without_one(tmp_path, monkeypatch):
    """No silent fallback to the CPU: without ``--device`` the mesh's device
    is the card, and without one the CLI raises before any cell runs."""
    import torch

    from repro_torch.launch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "train_4k", "--multi-pod",
                     "single", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())
