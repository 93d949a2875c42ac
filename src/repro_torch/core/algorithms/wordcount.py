"""Word frequency count (paper §3.1.1, Fig. 4, Appendix A.1).

The counterpart of ``repro/core/algorithms/wordcount.py``, per-op mode.
Input lines are fixed-width int32 token-id rows (padding = -1), the output of
``data.synthetic.zipf_corpus``.  The mapper emits one ``(word_id, 1)`` pair
per live token, a batched emit.  The target is a ``DistHashMap`` keyed by word
id (``target="dense"`` counts into a ``[vocab]`` int32 tensor).  The
vocabulary bound goes in as ``key_range``, so the shuffle ships narrowed keys
and ``engine="pallas"`` sizes its combine table by distinct words.
"""
from __future__ import annotations

import torch

from repro_torch.core import DistHashMap
from repro_torch.core.session import BlazeSession, resolve


def wordcount_mapper(i, tokens, emit):
    emit(tokens, 1, mask=tokens >= 0)


def wordcount(
    lines,
    *,
    engine: str = "eager",
    capacity_per_shard: int | None = None,
    target: str = "hash",
    vocab_size: int | None = None,
    mode: str = "per_op",
    return_stats: bool = False,
    session: BlazeSession | None = None,
):
    """Count token occurrences.

    ``target="hash"`` returns a ``DistHashMap`` (the open-vocabulary plan,
    the hash-aggregation kernel's regime under ``engine="pallas"``);
    ``target="dense"`` a ``[vocab_size]`` int32 tensor (the segment-reduce
    kernel's).  Returns the counts, or ``(counts, MapReduceStats)`` with
    ``return_stats=True``.
    """
    if target not in ("hash", "dense"):
        raise ValueError(f"unknown target {target!r}; choose 'hash' or 'dense'")
    if mode != "per_op":
        raise NotImplementedError(
            f"mode={mode!r} comes with the fused-program slice of the port; "
            "use mode='per_op'"
        )
    sess = resolve(session)
    lines_v = sess.distribute(lines)
    vocab = (
        vocab_size if vocab_size is not None
        else (int(lines.max()) + 1 if lines.size else 1)
    )
    if target == "dense":
        counts = torch.zeros((vocab,), dtype=torch.int32, device=sess.device)
        return sess.map_reduce(
            lines_v, wordcount_mapper, "sum", counts, engine=engine,
            return_stats=return_stats,
        )
    if capacity_per_shard is None:
        capacity_per_shard = max(64, 4 * vocab)
    hm: DistHashMap = sess.make_dist_hashmap(
        capacity_per_shard, (), torch.int32, "sum"
    )
    return sess.map_reduce(
        lines_v, wordcount_mapper, "sum", hm, engine=engine, key_range=vocab,
        return_stats=return_stats,
    )


def counts_dict(hm: DistHashMap) -> dict[int, int]:
    return {k: int(v) for k, v in hm.to_dict().items()}
