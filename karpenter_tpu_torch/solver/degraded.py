"""Solver degraded mode: the greedy fallback instead of a failed cycle
(port of ``karpenter_tpu/solver/degraded.py``).

``ResilientSolver`` wraps a primary backend and runs ``plan_defects``
on every plan it returns.  An exception or a structurally invalid plan
(non-finite cost, an offering index out of range, pod accounting that
does not partition the request, a partial gang) is handled by where the
primary runs (``device.holds_card``):

- a primary on the CPU degrades that one solve to ``solver/greedy.py``,
  loudly, as the reference's: a log line, an
  ``ERRORS{solver, degraded_backend_failure|degraded_invalid_plan}``
  sample, the primary's resident store invalidated (unless the failed
  dispatch already did), a ``solve.degraded`` span around the fallback
  and a ``degraded:`` tag on the plan's backend;
- a primary on the card never hands its window to the host: the
  exception raises with a log line, and an invalid plan invalidates the
  store and raises :class:`InvalidPlanError`.

The wrapper never stands a plain PyTorch version in for a kernel.  The
primary's constructor (device resolution, the kernel build) runs before
the wrapper exists, so a missing card or a failed ``nvcc`` raises out of
``make_solver``.

The structural check is cheap (O(pods)): full feasibility stays with
``solver/validate.py``; this gate only catches what a broken backend
could emit.
"""

from __future__ import annotations

import dataclasses
import math

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.apis.pod import pod_key
from karpenter_tpu_torch.device import holds_card
from karpenter_tpu_torch.solver.types import Plan, SolveRequest, SolverOptions
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("solver.degraded")


class InvalidPlanError(RuntimeError):
    """A primary on the card returned a plan that fails ``plan_defects``."""

    def __init__(self, defects: list[str]):
        super().__init__("invalid plan: " + "; ".join(defects[:3]))
        self.defects = defects


def plan_defects(plan: Plan, request: SolveRequest) -> list[str]:
    """Structural sanity of a plan against its request (cheap, O(pods))."""
    if plan is None:
        return ["backend returned no plan"]
    defects: list[str] = []
    if not math.isfinite(plan.total_cost_per_hour) \
            or plan.total_cost_per_hour < 0:
        defects.append(f"non-finite/negative total cost "
                       f"{plan.total_cost_per_hour!r}")
    catalog = request.catalog
    seen: set[str] = set()
    dupes = 0
    for ni, node in enumerate(plan.nodes):
        if not math.isfinite(node.price) or node.price < 0:
            defects.append(f"node{ni}: non-finite/negative price "
                           f"{node.price!r}")
        if not (0 <= node.offering_index < catalog.num_offerings):
            defects.append(f"node{ni}: offering index "
                           f"{node.offering_index} out of range")
        for pn in node.pod_names:
            if pn in seen:
                dupes += 1
            seen.add(pn)
    for pn in plan.unplaced_pods:
        if pn in seen:
            dupes += 1
        seen.add(pn)
    if dupes:
        defects.append(f"{dupes} pods assigned more than once")
    want = {pod_key(p) for p in request.pods}
    if seen != want:
        defects.append(f"pod accounting mismatch: {len(seen - want)} unknown, "
                       f"{len(want - seen)} missing")
    # no partial gang (the cheap form): a plan carrying a strict subset of
    # a gang's members degrades to the gang-aware greedy oracle
    placed_names = {pn for node in plan.nodes for pn in node.pod_names}
    tally: dict[str, list[int]] = {}
    for p in request.pods:
        if p.gang is not None:
            row = tally.setdefault(p.gang.name, [0, 0])
            row[1] += 1
            if pod_key(p) in placed_names:
                row[0] += 1
    for name, (placed, total) in tally.items():
        if 0 < placed < total:
            defects.append(f"partial gang {name}: {placed}/{total} "
                           f"members placed")
    return defects


def breadcrumbs() -> dict[str, float]:
    """The process's degradation breadcrumbs: every ``ERRORS`` sample
    whose kind starts with ``degraded_`` or ends in ``_fallback``,
    ``SERVING_WINDOWS{host_failover}`` and
    ``OVERCOMMIT_SOLVES{degraded}``.  A window that degraded anywhere
    moves at least one of them."""
    out = {f"errors{{{c},{k}}}": v
           for (c, k), v in metrics.ERRORS.samples().items()
           if k.startswith("degraded_") or k.endswith("_fallback")}
    out["serving_windows{host_failover}"] = \
        metrics.SERVING_WINDOWS.get("host_failover")
    out["overcommit_solves{degraded}"] = \
        metrics.OVERCOMMIT_SOLVES.get("degraded")
    return out


class ResilientSolver:
    """Wraps a primary backend; degrades single solves of a primary on
    the CPU to greedy, and raises those of a primary on the card.

    Unknown attributes (``last_stats``, ``resident``, ``serving``,
    ``service``, ``device``) delegate to the primary."""

    def __init__(self, primary, options: SolverOptions | None = None):
        self.primary = primary
        self.options = options or getattr(primary, "options", None) \
            or SolverOptions()
        self._fallback = None

    @property
    def fallback(self):
        if self._fallback is None:
            from karpenter_tpu_torch.solver.greedy import GreedySolver

            self._fallback = GreedySolver(
                dataclasses.replace(self.options, backend="greedy"))
        return self._fallback

    def __getattr__(self, name: str):
        return getattr(self.primary, name)

    def solve(self, request: SolveRequest) -> Plan:
        store = getattr(self.primary, "resident", None)
        seen = getattr(store, "invalidations", None)
        try:
            plan = self.primary.solve(request)
        except Exception as e:  # noqa: BLE001 — degrade, never fail the cycle
            # read after the solve: a remote primary learns its sidecar's
            # device from the sidecar's first reply
            if holds_card(self.primary):
                log.error("solver backend failed on the card",
                          backend=self.options.backend, error=str(e)[:200])
                raise
            log.error("solver backend failed; degrading to greedy",
                      backend=self.options.backend, error=str(e)[:200])
            return self._degrade(request, "backend_failure", store, seen)
        defects = plan_defects(plan, request)
        if defects:
            if holds_card(self.primary):
                log.error("solver produced invalid plan on the card",
                          backend=plan.backend, defects=defects[:3])
                self._invalidate(store, seen, "invalid_plan")
                raise InvalidPlanError(defects)
            log.error("solver produced invalid plan; degrading to greedy",
                      backend=plan.backend, defects=defects[:3])
            return self._degrade(request, "invalid_plan", store, seen)
        return plan

    @staticmethod
    def _invalidate(store, seen, reason: str) -> None:
        """A failed solve may have left the resident state half-applied:
        the next window rebuilds it from the host.  A store the failed
        dispatch has invalidated already is left as it is."""
        if store is None or store.invalidations != seen:
            return
        try:
            store.invalidate(reason)
        except Exception:  # noqa: BLE001 — degradation must not fail
            pass

    def _degrade(self, request: SolveRequest, reason: str, store,
                 seen) -> Plan:
        metrics.ERRORS.labels("solver", f"degraded_{reason}").inc()
        self._invalidate(store, seen, f"degraded_{reason}")
        with obs.span("solve.degraded", reason=reason,
                      backend=self.options.backend):
            plan = self.fallback.solve(request)
        plan.backend = f"degraded:{plan.backend}"
        return plan


__all__ = ["InvalidPlanError", "ResilientSolver", "breadcrumbs",
           "plan_defects"]
