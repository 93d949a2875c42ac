"""BlazeServe launcher: a long-lived multi-tenant query service (the port of
``repro/launch/serve.py``).

Starts a :class:`~repro_torch.serve.server.BlazeServer` with the three
standard synthetic datasets registered (``edges``, ``lines``, ``points``)
and serves the six built-in prepared queries over local HTTP until
interrupted, on the card by default or on the CPU with ``--device cpu``::

  PYTHONPATH=src python -m repro_torch.launch.serve --port 8787
  PYTHONPATH=src python -m repro_torch.launch.serve --port 8787 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --nodes 2 --shards 8

  curl -s localhost:8787/health
  curl -s -X POST localhost:8787/query -d \\
      '{"tenant": "alice", "query": "pagerank", "params": {"iters": 10}}'
  curl -s localhost:8787/stats

``--nodes N --shards S`` serves on a ``("node", "data")`` mesh of ``S``
shards stacked on the device in ``N`` node rows (``launch.mesh.
make_node_data_mesh``); ``/stats`` reports it as ``mesh_nodes`` and
``mesh_shards``.  A server runs in one process: on a mesh of several
processes it raises (ROADMAP.md, Queue 1 item 6d).

``--arch`` invocations are forwarded to ``repro_torch.launch.serve_lm`` (the
LM decode launcher), as the reference forwards them to its own.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.launch.serve_lm import generate  # noqa: F401

__all__ = ["build_server", "generate", "main", "register_standard_datasets"]


def register_standard_datasets(server, *, scale: str = "smoke",
                               seed: int = 0) -> None:
    """Register the three synthetic datasets the built-in queries default
    to: ``edges`` (R-MAT graph), ``lines`` (Zipf token corpus), ``points``
    (Gaussian clusters)."""
    from repro_torch.data import synthetic as S

    if scale == "smoke":
        graph_scale, n_lines, n_points, dim = 8, 512, 2048, 4
    else:
        graph_scale, n_lines, n_points, dim = 12, 8192, 1 << 15, 8
    edges = S.rmat_edges(graph_scale, seed=seed)
    lines, _true = S.zipf_corpus(n_lines, 16, 256, seed=seed)
    points, _centers = S.cluster_points(n_points, dim, 8, seed=seed)
    server.register_dataset("edges", edges, n_pages=2 ** graph_scale)
    server.register_dataset("lines", lines, vocab_size=256)
    server.register_dataset("points", points)


def build_server(*, host: str = "127.0.0.1", port: int = 0,
                 max_queue: int = 64, per_tenant: int = 8, max_batch: int = 8,
                 scale: str = "smoke", seed: int = 0, device=None, mesh=None):
    """A ready-to-start server with the standard datasets registered, its
    session on ``mesh`` when given, else on ``device`` (the card unless
    ``"cpu"``)."""
    from repro_torch.serve import BlazeServer

    server = BlazeServer(
        mesh=mesh, device=None if mesh is not None else device, host=host, port=port,
        max_queue=max_queue,
        per_tenant_inflight=per_tenant, max_batch=max_batch,
    )
    register_standard_datasets(server, scale=scale, seed=seed)
    return server


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if any(a == "--arch" or a.startswith("--arch=") for a in argv):
        print(
            "note: the LM decode launcher is repro_torch.launch.serve_lm; "
            "forwarding (use `python -m repro_torch.launch.serve_lm` directly).",
            file=sys.stderr,
        )
        from repro_torch.launch import serve_lm

        return serve_lm.main(argv)

    ap = argparse.ArgumentParser(description="BlazeServe query service")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--per-tenant", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--scale", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=1,
                    help="node rows of the (node, data) mesh")
    ap.add_argument("--shards", type=int, default=None,
                    help="shards stacked on the device (default: --nodes)")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import make_node_data_mesh

    mesh = make_node_data_mesh(args.nodes, n_shards=args.shards or args.nodes,
                               device=args.device)
    server = build_server(
        host=args.host, port=args.port, max_queue=args.max_queue,
        per_tenant=args.per_tenant, max_batch=args.max_batch,
        scale=args.scale, seed=args.seed, mesh=mesh,
    )
    server.start()
    print(json.dumps({
        "serving": server.url,
        "queries": server.queries,
        "datasets": sorted(server.datasets),
        "device": str(server.device),
        "mesh_shards": server.mesh.n_shards,
        "mesh_nodes": server.mesh.n_nodes,
    }))
    sys.stdout.flush()
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        print(json.dumps(server.stats_snapshot(), default=str))


if __name__ == "__main__":
    main()
