"""Solver-layer chaos: fault injection + independent plan validation.

:class:`UnstableSolver` makes the solver backend fail on a seeded
schedule, which is how scenarios exercise the production degraded mode
(``solver/degraded.py`` falling back to greedy).  :class:`ValidatingSolver`
is the harness's outermost wrapper: every plan that reaches actuation is
re-checked by ``solver/validate.py`` — the no-shared-code-path oracle —
and any violation is recorded for the invariant checker.
"""

from __future__ import annotations

import random

from karpenter_tpu_torch.chaos.trace import EventTrace
from karpenter_tpu_torch.solver.types import Plan, SolveRequest
from karpenter_tpu_torch.solver.validate import validate_plan


class SolverChaosError(RuntimeError):
    """The injected backend failure (distinct from real solver bugs)."""


class UnstableSolver:
    """Raises instead of solving with probability ``failure_rate``."""

    def __init__(self, inner, rng: random.Random, failure_rate: float,
                 trace: EventTrace | None = None):
        self.inner = inner
        self.rng = rng
        self.failure_rate = failure_rate
        self.trace = trace
        self.options = getattr(inner, "options", None)

    def solve(self, request: SolveRequest) -> Plan:
        if self.failure_rate > 0 and self.rng.random() < self.failure_rate:
            if self.trace is not None:
                self.trace.add("fault", method="solver.solve",
                               error="backend_failure")
            raise SolverChaosError("injected solver backend failure")
        return self.inner.solve(request)


class AffinityBlindSolver:
    """Fixture-only broken applier (``break_affinity`` profiles): solves
    with every pod's affinity terms and topology-spread constraints
    STRIPPED, while the cluster keeps the originals — placement then
    packs antagonists together and busts spread bounds, which is exactly
    what the ``affinity-satisfied`` invariant must catch (falsifiability:
    a checker that stays green against this wrapper proves nothing)."""

    def __init__(self, inner):
        self.inner = inner
        self.options = getattr(inner, "options", None)

    def solve(self, request: SolveRequest) -> Plan:
        import dataclasses

        blind = dataclasses.replace(
            request,
            pods=[dataclasses.replace(p, affinity=(), topology_spread=())
                  for p in request.pods])
        return self.inner.solve(blind)


class ValidatingSolver:
    """Runs the independent feasibility oracle on every plan; violations
    accumulate in ``violations`` (drained by the invariant checker).
    Every plan's attached unplaced reasons are additionally re-derived
    from the request via the explain consistency oracle
    (karpenter_tpu/explain/validate.py); contradictions accumulate in
    ``explain_violations`` for the ``explain-consistent`` invariant."""

    def __init__(self, inner, trace: EventTrace | None = None):
        self.inner = inner
        self.trace = trace
        self.options = getattr(inner, "options", None)
        self.violations: list[str] = []
        self.explain_violations: list[str] = []

    def solve(self, request: SolveRequest) -> Plan:
        plan = self.inner.solve(request)
        errors = validate_plan(plan, request.pods, request.catalog,
                               request.nodepool)
        if self.trace is not None:
            self.trace.add("solve", backend=plan.backend,
                           nodes=len(plan.nodes), placed=plan.placed_count,
                           unplaced=len(plan.unplaced_pods),
                           cost=round(plan.total_cost_per_hour, 4),
                           invalid=len(errors))
        self.violations.extend(errors)
        if plan.unplaced_pods:
            from karpenter_tpu_torch.explain.validate import check_plan_reasons
            from karpenter_tpu_torch.solver.encode import encode

            try:
                problem = encode(request.pods, request.catalog,
                                 request.nodepool)
                self.explain_violations.extend(
                    check_plan_reasons(problem, plan))
            except Exception as e:  # noqa: BLE001 — the check must not fail a solve
                self.explain_violations.append(
                    f"explain consistency check errored: {e!r}")
        return plan
