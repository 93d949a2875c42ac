"""Deterministic, seeded fault injection for the port's runtime.

The counterpart of ``repro/core/faults.py``, stdlib only and its own copy:
the same points, rules, registry and recovery ledger, so one ``BLAZE_FAULTS``
schedule fires on the same hits in both packages.  Fault tolerance is only
trustworthy if every failure the supervisor claims to handle can be
reproduced on demand: *named fault points* sit in the runtime's host-side
dispatch paths, and a process-wide registry of *rules* decides,
deterministically, which hits of which points raise.

==================  ====================================================
``dispatch``        a per-op or program dispatch (``mapreduce.py``,
                    ``program.py``)
``collective``      a cross-shard reduce on the runs that stand for the
                    reference's ``jax.jit`` trace: a stage's runs until
                    one succeeds (a program's on the card: its capture);
                    never a graph replay
``collective.inter``the inter-node hop of a hierarchical reduce on a
                    multi-node mesh (``core/collectives.py``), right
                    before the node partials cross it, on the same runs
                    as ``collective``
``kernel.segment``  the segment-reduce kernel path of a dense dispatch
``kernel.hash``     the hash-aggregation kernel path of a hash dispatch
``prefetch.read``   a block read inside the prefetch worker
                    (``data/pipeline.py``)
``checkpoint.write``a checkpoint write (``checkpoint/manager.py``)
``tuning.measure``  one autotuner candidate measurement
==================  ====================================================

Rules trigger on an exact hit number (``at=``), periodically (``every=``),
or with probability ``p=`` from a rule-local ``random.Random`` seeded from
``seed ^ crc32(point)``, so a schedule replays hit for hit.  Rules come from
the ``BLAZE_FAULTS`` environment variable (``"dispatch:at=3;kernel.hash:
p=0.1,seed=42,fatal"``) or from :func:`configure` / :func:`inject`.

A fired rule raises :class:`TransientFault` (retryable) or
:class:`FatalFault` (must propagate).  The registry keeps the *recovery
ledger*: every injected fault is disposed exactly once (``retried`` /
``degraded`` / ``escalated`` / ``fatal`` / ``absorbed``) by whichever
supervisor caught it, so

    ``injected_total == retried + degraded + escalated + fatal + absorbed``

is checkable from :func:`snapshot` (``balanced``) after any run.
:func:`record` marks the fault instance itself, so a fault handed across
threads (out of the prefetch worker) cannot be counted twice.  With no rule
armed, :func:`fault_point` is one attribute check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
import zlib

__all__ = [
    "DISPOSITIONS",
    "FatalFault",
    "FaultRegistry",
    "FaultRule",
    "InjectedFault",
    "POINTS",
    "RetryPolicy",
    "TransientFault",
    "configure",
    "fault_point",
    "inject",
    "record",
    "registry",
    "reset",
    "retry_in_place",
    "snapshot",
]

#: The canonical fault points threaded through the runtime.  The registry
#: accepts arbitrary names (new subsystems can add points without touching
#: this module), but these are the ones the test suite and docs rely on.
POINTS = (
    "dispatch",
    "collective",
    "collective.inter",
    "kernel.segment",
    "kernel.hash",
    "prefetch.read",
    "checkpoint.write",
    "tuning.measure",
)

#: Terminal outcomes a supervisor can assign to an injected fault.
DISPOSITIONS = ("retried", "degraded", "escalated", "fatal", "absorbed")

ENV_VAR = "BLAZE_FAULTS"


class InjectedFault(RuntimeError):
    """Base of every injected failure.  ``point`` names the fault point,
    ``hit`` is the 1-based hit count at which the rule fired, and ``fatal``
    tells the supervisor whether retrying is allowed."""

    fatal = False

    def __init__(self, point: str, hit: int):
        kind = "fatal" if self.fatal else "transient"
        super().__init__(f"injected {kind} fault at {point!r} (hit {hit})")
        self.point = point
        self.hit = hit
        self._disposed = False


class TransientFault(InjectedFault):
    """An injected failure a supervisor may retry, degrade, or absorb."""

    fatal = False


class FatalFault(InjectedFault):
    """An injected failure that must propagate — the chaos suite uses it to
    simulate a process crash mid-run."""

    fatal = True


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounds for supervised dispatch: at most ``attempts`` tries, sleeping
    ``backoff_s * multiplier**k`` between them, never past ``deadline_s``
    from the first attempt (``None`` = no deadline)."""

    attempts: int = 3
    backoff_s: float = 0.005
    multiplier: float = 2.0
    deadline_s: float | None = 30.0

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError("attempts must be >= 1")
        if self.backoff_s < 0 or self.multiplier < 1.0:
            raise ValueError("backoff_s must be >= 0 and multiplier >= 1")


@dataclasses.dataclass
class FaultRule:
    """One armed trigger.  Exactly one of ``at`` / ``every`` / ``p`` should
    be set; ``times`` caps total firings (``None`` = unlimited)."""

    point: str
    at: int | None = None
    every: int | None = None
    p: float = 0.0
    times: int | None = None
    seed: int = 0
    fatal: bool = False
    fired: int = 0

    def __post_init__(self):
        modes = (self.at is not None) + (self.every is not None) + (self.p > 0)
        if modes != 1:
            raise ValueError(
                f"rule for {self.point!r} needs exactly one of at=/every=/p=, "
                f"got at={self.at} every={self.every} p={self.p}"
            )
        if self.at is not None and self.at < 1:
            raise ValueError("at= is a 1-based hit number")
        if self.every is not None and self.every < 1:
            raise ValueError("every= must be >= 1")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError("p= must be in [0, 1]")
        # Rule-local RNG: seeded from (seed, point) so two rules with the
        # same seed on different points draw independent — but replayable —
        # schedules.
        self._rng = random.Random(
            (self.seed << 32) ^ zlib.crc32(self.point.encode())
        )

    def should_fire(self, hit: int) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.at is not None:
            return hit == self.at
        if self.every is not None:
            return hit % self.every == 0
        return self._rng.random() < self.p


class FaultRegistry:
    """Process-wide rule store, hit counters, and the recovery ledger.

    ``armed`` is a plain attribute read without the lock on the
    :func:`fault_point` fast path; it only ever flips under the lock.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._rules: list[FaultRule] = []
        self._hits: dict[str, int] = {}
        self._injected: dict[str, int] = {}
        self._dispositions = dict.fromkeys(DISPOSITIONS, 0)
        self.armed = False

    # -- configuration ---------------------------------------------------

    def configure(self, point: str, **kw) -> FaultRule:
        """Arm a rule at ``point``; see :class:`FaultRule` for the knobs."""
        rule = FaultRule(point, **kw)
        with self._lock:
            self._rules.append(rule)
            self.armed = True
        return rule

    def remove(self, rule: FaultRule) -> None:
        with self._lock:
            if rule in self._rules:
                self._rules.remove(rule)
            self.armed = bool(self._rules)

    def reset(self, *, env: bool = True) -> None:
        """Drop every rule and counter, then re-arm from ``BLAZE_FAULTS``
        (unless ``env=False``)."""
        with self._lock:
            self._rules = []
            self._hits = {}
            self._injected = {}
            self._dispositions = dict.fromkeys(DISPOSITIONS, 0)
            self.armed = False
        if env:
            spec = os.environ.get(ENV_VAR, "")
            for point, kw in _parse_env(spec):
                self.configure(point, **kw)

    # -- firing ----------------------------------------------------------

    def fire(self, point: str) -> None:
        """Count a hit at ``point`` and raise if an armed rule triggers."""
        with self._lock:
            hit = self._hits.get(point, 0) + 1
            self._hits[point] = hit
            for rule in self._rules:
                if rule.point != point or not rule.should_fire(hit):
                    continue
                rule.fired += 1
                self._injected[point] = self._injected.get(point, 0) + 1
                cls = FatalFault if rule.fatal else TransientFault
                raise cls(point, hit)

    # -- ledger ----------------------------------------------------------

    def record(self, disposition: str, fault: BaseException) -> None:
        """Dispose an injected fault.  No-op for real (non-injected)
        exceptions and for faults already disposed — each injected fault
        counts exactly once, whichever supervisor saw it first."""
        if disposition not in DISPOSITIONS:
            raise ValueError(
                f"unknown disposition {disposition!r}; one of {DISPOSITIONS}"
            )
        if not isinstance(fault, InjectedFault):
            return
        with self._lock:
            if fault._disposed:
                return
            fault._disposed = True
            self._dispositions[disposition] += 1

    def snapshot(self) -> dict:
        """Counters + the conservation verdict, for ``/stats`` and tests."""
        with self._lock:
            injected = dict(self._injected)
            dispositions = dict(self._dispositions)
            total = sum(injected.values())
            disposed = sum(dispositions.values())
            return {
                "armed": self.armed,
                "rules": len(self._rules),
                "hits": dict(self._hits),
                "injected": injected,
                "injected_total": total,
                "dispositions": dispositions,
                "disposed_total": disposed,
                "balanced": total == disposed,
            }


def _parse_env(spec: str) -> list[tuple[str, dict]]:
    """``"dispatch:at=3;kernel.hash:p=0.1,seed=42,fatal"`` → rule kwargs."""
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        point, _, conf = part.partition(":")
        point = point.strip()
        if not point:
            raise ValueError(f"{ENV_VAR}: empty fault point in {part!r}")
        kw: dict = {}
        for item in conf.split(","):
            item = item.strip()
            if not item:
                continue
            key, eq, val = item.partition("=")
            key = key.strip()
            if not eq:
                if key == "fatal":
                    kw["fatal"] = True
                    continue
                raise ValueError(f"{ENV_VAR}: bare flag {key!r} (only 'fatal')")
            val = val.strip()
            if key in ("at", "every", "times", "seed"):
                kw[key] = int(val)
            elif key == "p":
                kw[key] = float(val)
            elif key == "fatal":
                kw[key] = val.lower() in ("1", "true", "yes", "on")
            else:
                raise ValueError(f"{ENV_VAR}: unknown knob {key!r} in {part!r}")
        rules.append((point, kw))
    return rules


#: The process-wide registry every fault point consults.
registry = FaultRegistry()


def fault_point(name: str) -> None:
    """Hit the named fault point.  A no-op attribute check when nothing is
    armed; raises :class:`TransientFault` / :class:`FatalFault` when a rule
    triggers."""
    if not registry.armed:
        return
    registry.fire(name)


def configure(point: str, **kw) -> FaultRule:
    return registry.configure(point, **kw)


@contextlib.contextmanager
def inject(point: str, **kw):
    """Scoped injection: arm one rule, yield the registry, disarm on exit.
    Counters survive the block so tests can assert on :func:`snapshot`."""
    rule = registry.configure(point, **kw)
    try:
        yield registry
    finally:
        registry.remove(rule)


def record(disposition: str, fault: BaseException) -> None:
    registry.record(disposition, fault)


def reset(*, env: bool = True) -> None:
    registry.reset(env=env)


def retry_in_place(fn, tries: int = 3):
    """``fn()``, run again at once after a :class:`TransientFault`, at most
    ``tries`` tries in all: for an operation whose retry is bit-equal (a
    block read, a checkpoint write).  A :class:`FatalFault`, or the last
    try's fault, is recorded ``fatal`` and raised; real errors pass through."""
    for i in range(tries):
        try:
            return fn()
        except FatalFault as e:
            record("fatal", e)
            raise
        except TransientFault as e:
            if i + 1 >= tries:
                record("fatal", e)
                raise
            record("retried", e)


def snapshot() -> dict:
    return registry.snapshot()


# Arm from the environment at import, so `BLAZE_FAULTS=... pytest` works
# without any test-side setup.
if os.environ.get(ENV_VAR):
    registry.reset()
