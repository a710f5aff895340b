"""Degraded mode: the deterministic-requests fallback (port of
``karpenter_tpu/stochastic/degraded.py``).

The chance-constrained program can fail.  A failure that is not a
device fault (a host-side error of the route's program: a shape check,
a packing bug) must not fail the window: the dispatch strips the
stochastic leaf from the prepared window and from its template, and
re-runs the same base buffer through the FFD scan route (packing by
request, no overcommit; the hand kernel ``ffd_scan`` on the card), with
an ``ERRORS{solver, stochastic_fallback}`` sample and the
``karpenter_tpu_overcommit_solves_total{mode="degraded"}`` counter.
Requests bound usage from above, so a deterministic plan is
chance-feasible at any epsilon.

A ``faulttol.DeviceFaultError`` (a faulted device, a hand kernel whose
launch failed) is never stripped: it propagates to ``ResilientSolver``.
The reference strips where XLA reports a failure, at the dispatch and
at the fetch; the port's kernels report a bad launch synchronously, at
the dispatch (``faulttol/dispatch.py``), so the strip sits there.
"""

from __future__ import annotations

from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("stochastic.degraded")


def strip_stochastic(prep) -> None:
    """Disarm the stochastic route of a prepared window in place: its
    next dispatch, and that of its cached template (a broken program must
    not re-break every later solve of the window), runs the FFD scan on
    the unchanged base buffer."""
    prep.sto = None
    tmpl = getattr(prep, "tmpl", None)
    if tmpl is not None:
        tmpl.sto = None


def note_degraded(prep, error: Exception) -> None:
    """One degradation breadcrumb: log and metrics, then strip."""
    log.warning("stochastic kernel failed; deterministic-requests "
                "fallback engaged", error=str(error)[:300],
                G=prep.G_pad, O=prep.O_pad, N=prep.N)
    metrics.ERRORS.labels("solver", "stochastic_fallback").inc()
    metrics.OVERCOMMIT_SOLVES.labels("degraded").inc()
    strip_stochastic(prep)


def deterministic_problem(problem):
    """Problem-level fallback (host paths): the same window with the
    stochastic tensors dropped; packing reverts to requests."""
    if getattr(problem, "group_var", None) is None:
        return problem
    return problem.replace(group_mean=None, group_var=None,
                           overcommit_eps=0.0)
