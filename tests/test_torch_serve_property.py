"""The port's serving layer, mirroring ``tests/test_serve_property.py`` on
the CPU: random interleavings of {submit, stats, cached-resubmit} preserve
the ``ServerStats`` invariants.

The counters form small conservation laws (see ``repro_torch/serve/stats.py``):

* ``completed + failed + queued == submitted`` — every request that reached
  admission is in exactly one bucket at every instant;
* ``cache_hits + compiles == dispatched_plans`` — every executed plan
  resolution either hit the resident program cache or compiled;
* ``p50_ms <= p99_ms`` — both cut from one snapshot.

Ops run against one live server (dispatcher racing the submitting thread),
so the snapshots genuinely interleave with admission and dispatch.

Hypothesis gating follows tests/test_serialization.py: FAIL under
REQUIRE_HYPOTHESIS (CI installs hypothesis, so the suite must run there,
never skip).  Without hypothesis the same invariants run over seeded
pseudo-random interleavings instead, so the module still tests — rather
than skips — in minimal environments."""
import os
import random

import pytest

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError as e:
    if os.environ.get("REQUIRE_HYPOTHESIS"):
        raise ImportError(
            "REQUIRE_HYPOTHESIS is set but hypothesis failed to import — "
            "the property suite must run, not skip, in CI"
        ) from e
    HAVE_HYPOTHESIS = False

from repro_torch.serve import BlazeServer  # noqa: E402

# Three tiny pi plans; repeats across and within examples are the
# "cached resubmit" op by construction (the program cache is resident).
SIZES = (256, 512, 1024)


@pytest.fixture(scope="module")
def server():
    srv = BlazeServer(device="cpu", max_queue=256, per_tenant_inflight=256,
                      max_batch=4)
    srv.start()
    yield srv
    srv.stop()


def check_invariants(snap: dict) -> None:
    assert snap["completed"] + snap["failed"] + snap["queued"] == \
        snap["submitted"], snap
    assert snap["cache_hits"] + snap["compiles"] == \
        snap["dispatched_plans"], snap
    assert snap["p50_ms"] <= snap["p99_ms"], snap
    assert snap["queued"] >= 0, snap


def run_ops(server: BlazeServer, ops: list[tuple]) -> None:
    """Execute one interleaving, checking invariants after every op and
    after the example fully drains."""
    pending = []
    last = ("submit", SIZES[0], 1)
    for op in ops:
        if op[0] == "stats":
            check_invariants(server.stats_snapshot())
            continue
        if op[0] == "resubmit":
            op = last  # identical (query, params): exercises cache + dedup
        last = op
        _tag, n_samples, iters = op
        pending.append(server.submit(
            "prop", "pi", {"n_samples": n_samples, "iters": iters}
        ))
        check_invariants(server.stats_snapshot())
    for req in pending:
        assert req.done.wait(300), "request never completed"
        assert req.error is None, req.error
    snap = server.stats_snapshot()
    check_invariants(snap)
    # Everything admitted in this example has drained.
    assert snap["queued"] == 0
    # The whole module compiles at most one program per distinct plan
    # (``iters`` is NOT structural — it never forces a compile).
    assert snap["compiles"] <= len(SIZES)
    assert snap["compiles"] <= snap["dispatched_plans"]


if HAVE_HYPOTHESIS:
    ops_strategy = st.lists(
        st.one_of(
            st.tuples(st.just("submit"), st.sampled_from(SIZES),
                      st.integers(min_value=1, max_value=2)),
            st.tuples(st.just("resubmit")),
            st.tuples(st.just("stats")),
        ),
        min_size=1,
        max_size=12,
    )

    @settings(
        max_examples=15,
        deadline=None,
        suppress_health_check=[HealthCheck.too_slow],
    )
    @given(ops=ops_strategy)
    def test_interleavings_preserve_stats_invariants(server, ops):
        run_ops(server, ops)

else:

    @pytest.mark.parametrize("seed", range(8))
    def test_interleavings_preserve_stats_invariants(server, seed):
        rng = random.Random(seed)
        ops = []
        for _ in range(rng.randint(1, 12)):
            kind = rng.choice(("submit", "resubmit", "stats"))
            if kind == "submit":
                ops.append(("submit", rng.choice(SIZES), rng.randint(1, 2)))
            else:
                ops.append((kind,))
        run_ops(server, ops)
