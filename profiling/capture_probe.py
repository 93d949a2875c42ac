#!/usr/bin/env python3
"""Two repeat measurements on one card that ``chip_smoke.py`` takes only once.

Run from the repository root::

    python3 profiling/capture_probe.py [stream] [nccl] [--runs N]

``stream``: the fault phase's k-means stream (``cluster_points(10^8, 3, 5,
seed=0)``, blocks of 2^24 rows, 3 epochs, K1 ``pallas``), the distance (max
abs over the 5 x 3 centres) from one fault-free run of ``N`` more runs of
each kind: the same program again (what the smoke's spread samples),
a fresh program each run, and a fresh program under the smoke's faults
(``prefetch.read`` at 2, ``dispatch`` at 3, ``checkpoint.write`` at 1,
checkpoints every epoch); and the shift of the last epoch with one block
counted twice.  It says how wide the faulted stream's distance is beside
the fault-free spread, which sets the smoke's factor.

``nccl``: captures of the PageRank program (``pagerank._program_step``,
R-MAT 20 x 16, K1 ``pallas``, unroll 5) while a world-size-1 NCCL group is
up in this process, ``N`` rounds of: the program on the group's (1x8)
process mesh (``none`` and ``int8``), the same program on an in-process
(1x8) mesh (a twin), and a twin right after an eager per-op PageRank on the
process mesh (NCCL work still queued).  Each capture's outcome is counted;
a failure's message is kept.  ``TORCH_NCCL_ASYNC_ERROR_HANDLING`` is read
from the environment, so run it once with each setting.

One JSON line per result, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def emit(rec: dict) -> None:
    print(json.dumps(rec, default=str), flush=True)


def stream(runs: int) -> None:
    import importlib

    import numpy as np
    import torch
    from repro_torch.core import BlazeSession, DistVector, faults
    from repro_torch.data.synthetic import cluster_points

    # the module (the package's ``kmeans`` is the driver function)
    km_alg = importlib.import_module("repro_torch.core.algorithms.kmeans")

    dev = torch.device("cuda")
    pts, _ = cluster_points(100_000_000, 3, 5, seed=0)
    c0 = torch.from_numpy(pts[np.random.RandomState(0).choice(4096, 5, replace=False)]).to(dev)
    sess = BlazeSession(device=dev)
    km_c = sess.chunked(pts, 1 << 24)
    sstep, s0 = km_alg._stream_step(km_c, 5, 3, "pallas", "none", dev)
    prog = sess.program(sstep)
    clean, _ = sess.run_stream(prog, s0(c0), max_epochs=3)

    def dist(got):
        return float((got["centers"] - clean["centers"]).abs().max())

    same, fresh, faulted = [], [], []
    for _ in range(runs):
        same.append(dist(sess.run_stream(prog, s0(c0), max_epochs=3)[0]))
        fresh.append(dist(sess.run_stream(sess.program(sstep), s0(c0), max_epochs=3)[0]))
        ckpt = tempfile.mkdtemp(prefix="blaze-ckpt-")
        faults.configure("prefetch.read", at=2)
        faults.configure("dispatch", at=3)
        faults.configure("checkpoint.write", at=1)
        got, _ = sess.run_stream(sess.program(sstep), s0(c0), max_epochs=3, checkpoint=ckpt,
                                 checkpoint_every=1)
        retried = faults.snapshot()["dispositions"].get("retried")
        faults.reset(env=False)
        faulted.append((dist(got), retried))
    two, _ = sess.run_stream(prog, s0(c0), max_epochs=2)
    parts = [sess.map_reduce(
        DistVector(km_c.block_view(b).data, km_c.block_true_rows(b)),
        km_alg.assign_inertia_mapper, "sum", torch.zeros(5, 5, device=dev),
        engine="pallas", env=two["centers"]) for b in range(km_c.n_blocks)]
    acc = torch.stack(parts).sum(0)

    def refined(a):
        return a[:, :3] / torch.clamp(a[:, 3:4], min=1.0)

    emit({"stream": {
        "runs": runs, "same_program": same, "fresh_program": fresh,
        "faulted": [d for d, _ in faulted], "retried": [r for _, r in faulted],
        "centre_scale": float(clean["centers"].abs().max()),
        "eps_scale": float(torch.finfo(torch.float32).eps) * float(
            clean["centers"].abs().max()),
        "doubled_block_shift": float((refined(acc + parts[0]) - refined(acc)).abs().max())}})


def nccl(runs: int) -> None:
    import gc
    import importlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import BlazeSession, DistVector, data_mesh
    from repro_torch.core.algorithms import pagerank
    from repro_torch.data.synthetic import rmat_edges
    from repro_torch.launch.mesh import make_node_data_mesh

    # the module (the package's ``pagerank`` is the driver function)
    pr_mod = importlib.import_module("repro_torch.core.algorithms.pagerank")
    dev = torch.device("cuda")
    n_pages = 1 << 20
    edges_np = rmat_edges(20, 16, seed=0)
    edges = torch.from_numpy(edges_np).to(dev)
    deg = torch.from_numpy(np.bincount(edges_np[:, 0], minlength=n_pages)
                           .astype(np.int32)).to(dev)
    scores0 = torch.full((n_pages,), 1.0 / n_pages, device=dev)
    v = DistVector(edges, edges_np.shape[0])

    def program(sess, wire):
        step, s0 = pr_mod._program_step(v, deg, n_pages, 0.85, "pallas", wire)
        prog = sess.program(step)
        out, _ = sess.run_loop(prog, s0(scores0), cond=lambda s: float(s["delta"]) < 0.0,
                               max_iters=5, unroll=5)
        return out["scores"]

    def twin_mesh():
        # in process: make_node_data_mesh would honour the group, even of one
        mesh = data_mesh(8, device=dev)
        assert not mesh.process
        return mesh

    ref = program(BlazeSession(mesh=twin_mesh()), "none")  # builds K1, no group up
    store = tempfile.mkdtemp(prefix="blaze-store-")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store, "s"), 1),
                            world_size=1, rank=0)
    kinds = ("process", "twin", "twin_after_eager", "process_int8")
    outcome = {k: {"ok": 0, "failed": 0, "errors": []} for k in kinds}
    t0 = time.perf_counter()
    try:
        psess = BlazeSession(mesh=make_node_data_mesh(None, n_shards=8, device=dev))
        assert psess.mesh.process
        for _ in range(runs):
            for kind in kinds:
                try:
                    if kind == "process":
                        got = program(psess, "none")
                    elif kind == "process_int8":
                        got = None
                        program(psess, "int8")
                    else:
                        if kind == "twin_after_eager":
                            pagerank(edges_np, n_pages, tol=0.0, max_iters=2,
                                     engine="pallas", session=psess)
                        got = program(BlazeSession(mesh=twin_mesh()), "none")
                    torch.cuda.synchronize()
                    if got is not None and float((got - ref).abs().max()) > 1e-4 * float(ref.max()):
                        raise AssertionError(f"scores off by {(got - ref).abs().max()}")
                    outcome[kind]["ok"] += 1
                except Exception as e:  # counted, and the loop goes on
                    outcome[kind]["failed"] += 1
                    outcome[kind]["errors"].append(f"{type(e).__name__}: {e}"[:400])
                gc.collect()
    finally:
        dist.destroy_process_group()
    emit({"nccl_capture": {
        "runs": runs, "TORCH_NCCL_ASYNC_ERROR_HANDLING": os.environ.get(
            "TORCH_NCCL_ASYNC_ERROR_HANDLING"), "torch": torch.__version__,
        "nccl": ".".join(map(str, torch.cuda.nccl.version())),
        "seconds": time.perf_counter() - t0, "outcome": outcome}})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parts", nargs="*", default=["stream", "nccl"])
    ap.add_argument("--runs", type=int, default=8)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("capture_probe: no CUDA device", file=sys.stderr)
        return 1
    for part in args.parts:
        {"stream": stream, "nccl": nccl}[part](args.runs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
