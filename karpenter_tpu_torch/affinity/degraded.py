"""Degraded mode: the unconstrained-scan fallback (port of
``karpenter_tpu/affinity/degraded.py``).

The affinity-gated program can fail.  A failure that is not a device
fault (a host-side error of the route's program) must not fail the
window: the dispatch strips the affinity leaf from the prepared window
and from its template, and re-runs the same base buffer through the FFD
scan route (the hand kernel ``ffd_scan`` on the card), with an
``ERRORS{solver, affinity_fallback}`` sample.  Correctness survives: the
decode choke (``affinity/enforce.py``) runs on every plan whichever
program produced it, so a degraded window drops edge-violating
placements instead of shipping them.

A ``faulttol.DeviceFaultError`` is never stripped: it propagates to
``ResilientSolver``.  The port's kernels report a bad launch at the
dispatch, where XLA reports it at the fetch, so the strip sits at the
dispatch (``solver/torch_backend.py``).
"""

from __future__ import annotations

from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("affinity.degraded")


def strip_affinity(prep) -> None:
    """Disarm the affinity route of a prepared window in place: its next
    dispatch, and that of its cached template, runs the FFD scan on the
    unchanged base buffer."""
    prep.aff = None
    tmpl = getattr(prep, "tmpl", None)
    if tmpl is not None:
        tmpl.aff = None


def note_degraded(prep, error: Exception) -> None:
    """One degradation breadcrumb: log and metric, then strip."""
    log.warning("affinity kernel failed; unconstrained-scan fallback "
                "engaged (choke-point enforcement still applies)",
                error=str(error)[:300],
                G=prep.G_pad, O=prep.O_pad, N=prep.N)
    metrics.ERRORS.labels("solver", "affinity_fallback").inc()
    strip_affinity(prep)


def unconstrained_problem(problem):
    """Problem-level fallback (host paths): the same window with the
    affinity index dropped; the scan ignores edges, the decode choke
    still enforces them."""
    if getattr(problem, "aff", None) is None:
        return problem
    return problem.replace(aff=None)
