"""Deterministic crashpoint injection (docs/design/recovery.md).

The journal and the actuation plane expose named *crashpoints* — the
exact instants where a process death is most damaging (before the first
RPC, between staged allocations, after a create but before its response
is durable, mid-eviction, mid-journal-append).  Production code calls
:func:`hit` at each one; with no injector installed that is a single
``None`` check.  The crashpoint chaos harness (``chaos/crash.py``)
installs a seeded :class:`CrashInjector` that kills the "process" by
raising :class:`SimulatedCrash` at predetermined hit counts.

``SimulatedCrash`` subclasses ``BaseException`` on purpose: a real
``kill -9`` does not stop for ``except Exception`` handlers, so the
simulated one must tear through the retry stack, the degraded-mode
wrappers, and the per-node create loop exactly the same way.

(Copy of ``karpenter_tpu/recovery/crashpoints.py``.)
"""

from __future__ import annotations

import random
from contextlib import contextmanager

# The catalog (docs/design/recovery.md "crashpoint catalog").  Names are
# stable: the chaos matrix and the replay commands key on them.
CRASHPOINTS: tuple[str, ...] = (
    "actuate.pre_rpc",          # intent durable, no RPC issued yet
    "actuate.mid_create",       # VNI allocated, instance not
    "actuate.post_create",      # instance exists, response not yet durable
    "provision.pre_nominate",   # claim registered, pods not nominated
    "preempt.mid_evict",        # some of a plan's victims evicted
    "journal.append",           # the journal write itself interrupted
)


class SimulatedCrash(BaseException):
    """The operator process died here.  BaseException: nothing in the
    controller plane may catch and survive it."""

    def __init__(self, crashpoint: str, hit_no: int):
        super().__init__(f"simulated crash at {crashpoint} (hit {hit_no})")
        self.crashpoint = crashpoint
        self.hit_no = hit_no


class CrashInjector:
    """Crash at seeded, deterministic hit counts of ONE crashpoint.

    The schedule is fully determined by ``(crashpoint, seed)``: crash
    hit numbers are drawn once from a dedicated stream, so the same
    cell replays the same crashes — the determinism contract the
    trace-digest comparison enforces.
    """

    def __init__(self, crashpoint: str, seed: int, *, max_crashes: int = 3,
                 first_hit_range: tuple[int, int] = (1, 4),
                 gap_range: tuple[int, int] = (2, 8)):
        if crashpoint not in CRASHPOINTS:
            raise ValueError(f"unknown crashpoint {crashpoint!r}; "
                             f"known: {CRASHPOINTS}")
        self.crashpoint = crashpoint
        self.seed = seed
        rng = random.Random(f"crash:{crashpoint}:{seed}")
        hits: list[int] = []
        nxt = rng.randint(*first_hit_range)
        for _ in range(max_crashes):
            hits.append(nxt)
            nxt += rng.randint(*gap_range)
        self.crash_hits = frozenset(hits)
        self.counts: dict[str, int] = {}
        self.crashes = 0
        self.armed = True

    def disarm(self) -> None:
        """Quiesce: count hits but never crash again."""
        self.armed = False

    def hit(self, name: str) -> None:
        n = self.counts.get(name, 0) + 1
        self.counts[name] = n
        if self.armed and name == self.crashpoint and n in self.crash_hits:
            self.crashes += 1
            raise SimulatedCrash(name, n)


_injector: CrashInjector | None = None


def hit(name: str) -> None:
    """Production no-op; under an installed injector, maybe die here."""
    inj = _injector
    if inj is not None:
        inj.hit(name)


@contextmanager
def installed(injector: CrashInjector):
    """Install ``injector`` for the block (single-threaded harness use,
    same contract as VirtualClock.installed)."""
    global _injector
    prev = _injector
    _injector = injector
    try:
        yield injector
    finally:
        _injector = prev
