"""karpenter_tpu_torch.obs — dependency-free tracing + flight recorder
(port of ``karpenter_tpu/obs``: the span API, the placement ledger, the
device telemetry ``devtel``, the sampled profiler ``prof``, the anomaly
watchdog and the telemetry wire ``telemetry_words``).

Module-level helpers route through one process-wide :class:`Tracer` so
call sites stay one-liners::

    from karpenter_tpu_torch import obs

    with obs.span("actuate.create", zone=zone) as sp:
        ...
        sp.set("claim", claim.name)

    obs.record("solve.h2d", t0, t1)        # retroactive phase span
    obs.instant("pod.event", pod=key)      # zero-duration marker

The chaos harness swaps in a scenario-scoped tracer with :func:`use`
(fresh deterministic id counter per seeded run); bench resets the
recorder between measurement sections with :func:`reset_recorder`.
"""

from __future__ import annotations

from contextlib import contextmanager

from karpenter_tpu_torch.obs.trace import (  # noqa: F401 (public API re-exports)
    FlightRecorder, Span, Tracer, current_span, now,
)
# AFTER trace, as in the reference (whose utils package imports a
# batcher that reads ``obs.now`` while this package is still loading).
from karpenter_tpu_torch.obs.ledger import PlacementLedger  # noqa: F401,E402

_tracer = Tracer()
_ledger = PlacementLedger()


def get_tracer() -> Tracer:
    return _tracer


def get_recorder() -> FlightRecorder:
    return _tracer.recorder


def get_ledger() -> PlacementLedger:
    return _ledger


def span(name: str, **kwargs) -> Span:
    return _tracer.span(name, **kwargs)


def record(name: str, start: float, end: float, **kwargs) -> Span:
    return _tracer.record(name, start, end, **kwargs)


def instant(name: str, **attrs) -> None:
    _tracer.instant(name, **attrs)


def event(name: str, **fields) -> None:
    """Attach an event to the active span; dropped when none is open."""
    cur = current_span()
    if cur is not None:
        cur.event(name, **fields)


def reset_recorder(capacity: int = 64, error_capacity: int = 32) -> None:
    """Swap the default tracer onto a fresh recorder (bench measurement
    sections; test isolation)."""
    _tracer.recorder = FlightRecorder(capacity=capacity,
                                      error_capacity=error_capacity)


@contextmanager
def use(tracer: Tracer):
    """Route the module-level helpers through ``tracer`` for the block —
    the chaos harness's per-scenario isolation (deterministic ids)."""
    global _tracer
    prev = _tracer
    _tracer = tracer
    try:
        yield tracer
    finally:
        _tracer = prev


@contextmanager
def use_ledger(ledger: PlacementLedger):
    """Route ledger stamps through ``ledger`` for the block — the soak
    harness installs a fresh one so a production-day run's accounting
    never mixes with ambient process state (mirrors :func:`use`)."""
    global _ledger
    prev = _ledger
    _ledger = ledger
    try:
        yield ledger
    finally:
        _ledger = prev


def phase_durations(prefix: str = "solve.") -> dict[str, list[float]]:
    """name -> [duration_s] of every retained span under ``prefix`` —
    bench's per-phase breakdown source (same spans the recorder serves,
    not a parallel set of perf_counter pairs)."""
    out: dict[str, list[float]] = {}
    for _tid, _status, _root, spans in _tracer.recorder.traces():
        for sp in spans:
            if sp.name.startswith(prefix):
                out.setdefault(sp.name, []).append(sp.duration_s)
    return out


def last_solve_breakdown() -> dict[str, float]:
    """{phase: ms} of the newest trace containing solve phase spans —
    the /statusz "last solve" readout."""
    for _tid, _status, _root, spans in _tracer.recorder.traces():
        phases = {sp.name.removeprefix("solve."):
                  round(sp.duration_s * 1000.0, 3)
                  for sp in spans if sp.name.startswith("solve.")}
        if phases:
            return phases
    return {}
