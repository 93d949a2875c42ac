"""Word frequency count (paper §3.1.1, Fig. 4, Appendix A.1).

The counterpart of ``repro/core/algorithms/wordcount.py``.  Input lines are
fixed-width int32 token-id rows (padding = -1), the output of
``data.synthetic.zipf_corpus``.  The mapper emits one ``(word_id, 1)`` pair
per live token, a batched emit.  The target is a ``DistHashMap`` keyed by word
id (``target="dense"`` counts into a ``[vocab]`` int32 tensor).  The
vocabulary bound goes in as ``key_range``, so the shuffle ships narrowed keys
and ``engine="pallas"`` sizes its combine table by distinct words.

``mode="per_op"`` runs one dispatch a pass; ``iters > 1`` re-counts the same
batch (the streaming-aggregation setting).  ``mode="program"`` plans the pass
as a program whose hash table is threaded through the iterations, and
``run_loop(unroll=U)`` runs ``iters`` passes in ``ceil(iters / U)``
dispatches (CUDA graph replays on the card) with no host sync between them.

Lines given as a ``ChunkedDistVector`` (out of core; ``vocab_size`` is then
required) run one stage a block per op, or with ``mode="program"`` one graph
replay a block through ``session.run_stream``, ``iters`` epochs, the hash
table accumulating across blocks as it does across passes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import ChunkedDistVector, DistHashMap
from repro_torch.core.containers import Mesh
from repro_torch.core.session import BlazeSession, resolve


def wordcount_mapper(i, tokens, emit):
    emit(tokens, 1, mask=tokens >= 0)


def _program_step(lines_v, hm, vocab_bound: int, engine: str):
    """(step_fn, initial state) for the planned word count: one hash-target
    node a pass (or a block, for chunked lines), the table threaded through
    the iterations."""

    def step(ctx, s):
        ctx.map_reduce(lines_v, wordcount_mapper, "sum", hm, engine=engine,
                       key_range=vocab_bound)
        return {"it": s["it"] + 1}

    return step, {"it": torch.zeros((), dtype=torch.int32, device=hm.table.keys.device)}


@dataclasses.dataclass
class WordCountResult:
    """Multi-pass word count: counts and the fusion counters."""

    counts: DistHashMap
    iterations: int
    compiles: int = 0  # per-op stages built
    program_compiles: int = 0  # program plans / graph captures (mode="program")
    dispatches: int = 0  # dispatches across the loop
    host_syncs: int = 0  # blocking host materialisations across the loop


def wordcount(
    lines,
    *,
    engine: str = "eager",
    capacity_per_shard: int | None = None,
    target: str = "hash",
    vocab_size: int | None = None,
    mode: str = "per_op",
    iters: int = 1,
    unroll: int = 1,
    return_stats: bool = False,
    mesh: Mesh | None = None,
    session: BlazeSession | None = None,
):
    """Count token occurrences.

    ``target="hash"`` returns a ``DistHashMap`` (the open-vocabulary plan,
    the hash-aggregation kernel's regime under ``engine="pallas"``);
    ``target="dense"`` a ``[vocab_size]`` int32 tensor (the segment-reduce
    kernel's).  With the defaults (``per_op``, ``iters=1``) it returns the
    counts, or ``(counts, MapReduceStats)`` with ``return_stats=True``;
    ``mode="program"`` (hash target) and ``iters > 1`` return a
    :class:`WordCountResult`.
    """
    if target not in ("hash", "dense"):
        raise ValueError(f"unknown target {target!r}; choose 'hash' or 'dense'")
    if mode not in ("per_op", "program"):
        raise ValueError(f"unknown mode {mode!r}; choose 'per_op' or 'program'")
    sess, mesh = resolve(session, mesh)
    is_chunked = isinstance(lines, ChunkedDistVector)
    if is_chunked:
        if vocab_size is None:
            raise ValueError("chunked (out-of-core) wordcount needs an explicit vocab_size")
        lines_v = lines
    else:
        lines_v = sess.distribute(lines, mesh=mesh)
    vocab = (
        vocab_size if vocab_size is not None
        else (int(lines.max()) + 1 if lines.size else 1)
    )
    if target == "dense":
        if mode == "program":
            raise ValueError(
                "mode='program' wordcount targets the hash path; use the "
                "generic session.program for dense iteration"
            )
        counts = torch.zeros((vocab,), dtype=torch.int32, device=mesh.device)
        return sess.map_reduce(
            lines_v, wordcount_mapper, "sum", counts, engine=engine,
            return_stats=return_stats, mesh=mesh,
        )
    if capacity_per_shard is None:
        capacity_per_shard = max(64, 4 * vocab)
    hm: DistHashMap = sess.make_dist_hashmap(
        capacity_per_shard, (), torch.int32, "sum", mesh=mesh
    )
    compiles0 = sess.stats.compiles
    dispatches0 = sess.stats.dispatches
    syncs0 = sess.stats.host_syncs
    if mode == "program":
        step, state = _program_step(lines_v, hm, vocab, engine)
        prog = sess.program(step, mesh=mesh)
        if is_chunked:
            # Each epoch replays the graph once a block; the table
            # accumulates across blocks as across passes.
            state, info = sess.run_stream(prog, state, max_epochs=iters)
            return WordCountResult(
                counts=prog.hash_result(hm),
                iterations=info.epochs,
                compiles=sess.stats.compiles - compiles0,
                program_compiles=info.compiles,
                dispatches=sess.stats.dispatches - dispatches0,
                host_syncs=sess.stats.host_syncs - syncs0,
            )
        state, info = sess.run_loop(prog, state, max_iters=iters, unroll=unroll)
        return WordCountResult(
            counts=prog.hash_result(hm),
            iterations=info.iterations,
            compiles=sess.stats.compiles - compiles0,
            program_compiles=info.compiles,
            dispatches=sess.stats.dispatches - dispatches0,
            host_syncs=sess.stats.host_syncs - syncs0,
        )
    stats = None
    for _ in range(iters):
        hm, stats = sess.map_reduce(
            lines_v, wordcount_mapper, "sum", hm, engine=engine, key_range=vocab,
            return_stats=True, mesh=mesh,
        )
    if iters > 1:
        return WordCountResult(
            counts=hm,
            iterations=iters,
            compiles=sess.stats.compiles - compiles0,
            dispatches=sess.stats.dispatches - dispatches0,
            host_syncs=sess.stats.host_syncs - syncs0,
        )
    return (hm, stats) if return_stats else hm


def counts_dict(hm: DistHashMap) -> dict[int, int]:
    return {k: int(v) for k, v in hm.to_dict().items()}
