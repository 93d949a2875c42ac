"""BlazeServe on the PyTorch port: three tenants querying all six paper
algorithms against one resident server over local HTTP.

The port's copy of ``examples/serve_queries.py``.  The server builds each
distinct plan once (one CUDA-graph capture on the card); every later query,
from any tenant, replays the resident program, and compatible concurrent
queries coalesce into micro-batched dispatches.  The closing stats line
shows the ledger: compiles against cache hits, batched dispatches, p50/p99
latency.  On the card unless ``--device cpu`` is given (without CUDA the
default raises); on the card the queries run the kernels.

Run:  PYTHONPATH=src python3 examples_torch/serve_queries.py [--device cpu]
"""
import argparse
import threading

from repro_torch.launch.serve import build_server
from repro_torch.serve import BlazeClient

QUERIES = [
    ("pi", {"n_samples": 4096, "iters": 2}),
    ("pagerank", {"iters": 10}),
    ("wordcount", {"iters": 1}),
    ("kmeans", {"k": 4, "iters": 5}),
    ("gmm", {"k": 2, "iters": 3}),
    ("knn", {"k": 5, "query": [0.0, 0.0, 0.0, 0.0]}),
]
TENANTS = ("alice", "bob", "carol")


def describe(query, result):
    if query == "pi":
        return f"pi~{result['pi']:.4f}"
    if query == "pagerank":
        return f"delta={result['delta']:.2e}"
    if query == "wordcount":
        return f"{len(result['keys'])} distinct words"
    if query == "kmeans":
        return f"inertia={result['inertia']:.1f}"
    if query == "gmm":
        return f"ll={result['log_likelihood']:.1f}"
    return f"nearest at d={result['distances'][0]:.3f}"


def run(device=None, tenants=TENANTS, echo=None) -> dict:
    """Every tenant sends the six queries, one thread a tenant, to one
    server on ``device`` (the card unless ``"cpu"``).  Returns each
    ``(tenant, query)``'s result and meta, the server's address and queries,
    and its closing stats snapshot; ``echo(line)`` gets a line a reply."""
    server = build_server(scale="smoke", max_queue=128, per_tenant=32,
                          device=device).start()
    if echo is not None:
        echo(f"serving {sorted(server.queries)} at {server.url}\n")
    results, lock = {}, threading.Lock()

    def tenant(name):
        client = BlazeClient(server.url, tenant=name)
        for query, params in QUERIES:
            result, meta = client.query(query, params)
            with lock:
                results[(name, query)] = (result, meta)
            if echo is not None:
                echo(f"  {name:6s} {query:10s} {describe(query, result):24s} "
                     f"cache={meta['cache']:8s} plan={meta['plan_hash']}")

    try:
        threads = [threading.Thread(target=tenant, args=(n,)) for n in tenants]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = server.stats_snapshot()
    finally:
        server.stop()
    if len(results) != len(tenants) * len(QUERIES):
        raise RuntimeError(f"{len(results)} of {len(tenants) * len(QUERIES)} queries "
                           "answered")
    return {"url": server.url, "queries": sorted(server.queries), "results": results,
            "stats": snap}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    res = run(args.device, echo=lambda line: print(line, flush=True))
    snap = res["stats"]
    print(
        f"\n{snap['completed']} queries, {snap['compiles']} compiles, "
        f"{snap['cache_hits']} cache hits, "
        f"{snap['batched_dispatches']} micro-batched dispatches "
        f"({snap['coalesced_queries']} coalesced); "
        f"p50={snap['p50_ms']:.1f}ms p99={snap['p99_ms']:.1f}ms "
        f"({snap['throughput_qps']:.1f} q/s)"
    )
    return res


if __name__ == "__main__":
    main()
