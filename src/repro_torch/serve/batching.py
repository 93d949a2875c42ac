"""Micro-batching policy: which concurrent queries coalesce, and how (the
port of ``repro/serve/batching.py``).

The dispatcher serves the queue in **supersteps** (one batch per cycle)
rather than request-at-a-time — the BSP-style fix for per-request dispatch
overhead (Pace, arXiv:1203.2081) applied across *requests* instead of
across iterations:

1. **Plan grouping** (``AdmissionQueue.take_batch``): the head request plus
   every queued request with the same ``plan_key`` — they share one
   resident compiled program, so serving them together means one program
   lookup, zero additional compiles, and back-to-back dispatches of one
   executable.
2. **Dedup** (:func:`dedup_groups`, here): within the batch, requests with
   equal ``exec_key`` (same plan AND same parameters) are the *same*
   computation — one execution's result fans out to all of them.
3. **One sync** (``BlazeServer._execute_batch``): every execution in the
   batch is dispatched asynchronously (each iteration one CUDA graph replay
   enqueued on the dispatcher's stream, its per-request state built without
   a blocking copy); the host blocks **once** for the whole batch (one CUDA
   event recorded after the last group's dispatch, then synchronised)
   before any result is materialised.  The accept loop never syncs at all —
   admission happens on HTTP threads that do no session work.

``ServerStats`` counts a cycle that served ≥ 2 requests as a
``batched_dispatch`` and every request beyond the first as ``coalesced``.
"""
from __future__ import annotations

from repro_torch.serve.admission import Request

__all__ = ["dedup_groups"]


def dedup_groups(batch: list[Request]) -> list[list[Request]]:
    """Partition a plan-compatible batch into execution groups.

    Requests with equal ``exec_key`` land in one group (first-submitted
    first); each group costs exactly one execution, and members beyond the
    leader are dedup hits.  Group order preserves submission order of the
    leaders.
    """
    groups: dict[tuple, list[Request]] = {}
    order: list[tuple] = []
    for req in batch:
        if req.exec_key not in groups:
            groups[req.exec_key] = []
            order.append(req.exec_key)
        groups[req.exec_key].append(req)
    return [groups[k] for k in order]
