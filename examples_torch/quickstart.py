"""Quickstart: the Blaze MapReduce API in five minutes, on the PyTorch port.

The port's copy of ``examples/quickstart.py``: the same five steps at the
same sizes through ``repro_torch.core``, on the card unless ``--device
cpu`` is given (without CUDA the default raises).

Run:  PYTHONPATH=src python3 examples_torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (
    BlazeSession,
    DistRange,
    data_mesh,
    distribute,
    make_dist_hashmap,
    map_reduce,
    set_default_session,
    topk,
)
from repro_torch.core.algorithms import estimate_pi
from repro_torch.core.containers import resolve_device

PI_SAMPLES = 1_000_000
N_POINTS = 10_000
ITERS = 10

# token ids, -1 = padding
LINES = np.array([[3, 1, 4, 1], [5, 9, 2, 6], [5, 3, 5, -1]], dtype=np.int32)


def wordcount_mapper(line_idx, tokens, emit):
    emit(tokens, 1, mask=tokens >= 0)  # batched emit, masked lanes


def squares_mapper(v, emit):
    emit(v % 4, v * v)  # key = v mod 4, value = v²


def nearest_origin(x):
    return -torch.sum(x * x)


def scaled_sum_mapper(v, emit, env):
    emit(0, v * env)  # env = this iteration's scale factor


def run(device=None, pi_samples: int = PI_SAMPLES, n_points: int = N_POINTS,
        iters: int = ITERS) -> dict:
    """The five steps on ``device`` (the card unless ``"cpu"``): π's
    estimate and hit count, the word counts, Σ v² by v % 4, the 5 points
    nearest the origin, and the scaled sum after ``iters`` iterations with
    the session's cache counters."""
    dev = resolve_device(device)
    # the free map_reduce / topk run on the process's default session: one
    # on this device for the run
    prev = set_default_session(BlazeSession(device=dev))
    try:
        # 1. Monte-Carlo π: the paper's Appendix A.2, small fixed key range
        pi = estimate_pi(pi_samples)

        # 2. Word count: the paper's Appendix A.1, DistHashMap target
        mesh = data_mesh(device=dev)
        lines_v = distribute(LINES, mesh=mesh)
        counts = make_dist_hashmap(64, (), torch.int32, "sum", mesh=mesh)
        counts = map_reduce(lines_v, wordcount_mapper, "sum", counts)
        words = {int(k): int(v) for k, v in sorted(counts.to_dict().items())}

        # 3. A custom mapper over a DistRange with a dense target
        sums = map_reduce(DistRange(0, 100, 1), squares_mapper, "sum",
                          torch.zeros(4, dtype=torch.int32, device=dev))

        # 4. Distributed top-k with a custom score
        pts = distribute(np.random.RandomState(0).randn(n_points, 3).astype(np.float32),
                         mesh=mesh)
        closest = topk(pts, 5, score_fn=nearest_origin)  # nearest to 0
    finally:
        set_default_session(prev)

    # 5. Iterative MapReduce with a BlazeSession: one stage, N dispatches.
    # Iteration-varying state goes through ``env`` (the mapper stays
    # static), so the session reuses one stage for every iteration.
    sess = BlazeSession(device=dev)
    scale = torch.tensor(1.0, device=dev)
    for _ in range(iters):
        total = sess.map_reduce(DistRange(0, 1000, 1), scaled_sum_mapper, "sum",
                                torch.zeros(1, dtype=torch.float32, device=dev),
                                env=scale)
        scale = scale * 0.5
    return {"pi": pi, "pi_hits": round(pi * pi_samples / 4), "word_counts": words,
            "squares": [int(x) for x in sums.cpu()], "closest": closest,
            "total": float(total[0]), "session": sess.cache_info()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    res = run(args.device)
    print("π ≈", res["pi"])
    print("word counts:", res["word_counts"])
    print("Σ v² by v%4:", res["squares"])
    print("5 points nearest the origin:\n", res["closest"])
    print("session after 10 iterations:", res["session"])  # compiles=1
    return res


if __name__ == "__main__":
    main()
