"""Multi-pass streaming aggregation as ONE fused program, on the PyTorch port.

The port's copy of ``examples/streaming_aggregation.py``.  The word-count
shape of the paper's resident hot loop: every round a batch of lines is
counted into a ``DistHashMap`` (unbounded keys: the hash path, combined by
the K2 kernel under ``engine="pallas"`` on the card), and a second pass
reads the updated table in place to keep a count-of-counts histogram, both
inside one ``session.program``.  The hash table is per-shard state carried
through the device-resident loop, so N rounds cost 1 program compile (one
CUDA-graph capture on the card), ``⌈N/unroll⌉`` dispatches (graph replays)
and no per-round host sync; the table never leaves the device between
rounds.  On the card unless ``--device cpu`` is given (without CUDA the
default raises).

Run:  PYTHONPATH=src python3 examples_torch/streaming_aggregation.py [--device cpu]
"""
import argparse
import collections

import numpy as np
import torch

from repro_torch.core import BlazeSession, make_dist_hashmap
from repro_torch.core.algorithms.wordcount import wordcount_mapper

VOCAB = 2000
ROUNDS, UNROLL = 10, 5


def hist_mapper(word, count, emit):
    # histogram bucket = floor(log2(count)), capped: reads the hash table
    emit(torch.clamp(torch.log2(torch.clamp(count, min=1).float()).to(torch.int32),
                     max=15), 1)


def run(device=None, rounds: int = ROUNDS, unroll: int = UNROLL) -> dict:
    """``rounds`` rounds of the two passes as one program on ``device``
    (the card unless ``"cpu"``): the word counts, the histogram and the
    loop's contract (iterations, compiles, dispatches, host syncs)."""
    rng = np.random.RandomState(0)
    lines = rng.zipf(1.5, size=(256, 16)).clip(max=VOCAB - 1).astype(np.int32)

    sess = BlazeSession(device=device)
    dev = sess.device
    lines_v = sess.distribute(lines)
    counts_hm = make_dist_hashmap(4 * VOCAB, (), torch.int32, "sum", mesh=sess.mesh)

    def step(ctx, s):
        # pass 1: count this round's batch into the shared hash table
        counts = ctx.map_reduce(lines_v, wordcount_mapper, "sum", counts_hm,
                                engine="pallas", key_range=VOCAB)
        # pass 2: the count-of-counts histogram from the UPDATED table (a
        # LocalHashMap source: no collective, nothing leaves the program)
        hist = ctx.map_reduce(counts, hist_mapper, "sum",
                              torch.zeros(16, dtype=torch.int32, device=dev))
        return {"hist": hist, "round": s["round"] + 1}

    prog = sess.program(step)
    state = {"hist": torch.zeros(16, dtype=torch.int32, device=dev),
             "round": torch.zeros((), dtype=torch.int32, device=dev)}
    state, info = sess.run_loop(prog, state, max_iters=rounds, unroll=unroll)

    counts = prog.hash_result(counts_hm)
    ref = collections.Counter(lines.reshape(-1).tolist())
    got = {int(k): int(v) for k, v in counts.to_dict().items()}
    assert got == {k: rounds * v for k, v in ref.items()}
    assert info.compiles == 1 and info.dispatches == rounds // unroll
    assert info.host_syncs == 0
    return {"counts": got, "hist": state["hist"].cpu().numpy(), "info": info,
            "distinct": counts.size(), "overflow": counts.total_overflow()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    res = run(args.device)
    info = res["info"]
    print(f"rounds={info.iterations}  program_compiles={info.compiles}  "
          f"dispatches={info.dispatches}  host_syncs={info.host_syncs}")
    print(f"distinct words={res['distinct']}  overflow={res['overflow']}")
    print("count-of-counts (log2 buckets):",
          {i: int(v) for i, v in enumerate(res["hist"]) if v})
    print("OK — streaming aggregation fused: 1 compile, "
          f"{info.dispatches} dispatches for {info.iterations} rounds")
    return res


if __name__ == "__main__":
    main()
