"""Deterministic chaos harness: seeded fault injection across
cloud -> controllers -> solver, with invariant checking.

The recovery mechanisms exist in isolation (``cloud/retry.py``,
``core/circuitbreaker.py``, ``controllers/faults.py``); this package
proves they *compose*: a seeded :class:`ChaosProfile` drives a
:class:`ChaosCloud` wrapper over the fake cloud, scenarios run through
the deterministic ``ControllerManager.sync()`` path on a
:class:`VirtualClock`, and ``invariants.py`` checks system-level safety
between rounds.  Same (profile, seed) => identical event trace, so any
violation comes with an exact replay command.

See docs/design/chaos.md for the scenario format and invariant catalog.
"""

from karpenter_tpu_torch.chaos.clock import VirtualClock
from karpenter_tpu_torch.chaos.cloud import ChaosCloud
from karpenter_tpu_torch.chaos.invariants import InvariantChecker, Violation
from karpenter_tpu_torch.chaos.profile import (
    PROFILES, ChaosProfile, get_profile,
)
from karpenter_tpu_torch.chaos.runner import (
    ChaosHarness, ScenarioResult, run_matrix, run_scenario,
)
from karpenter_tpu_torch.chaos.trace import EventTrace

__all__ = [
    "ChaosCloud", "ChaosHarness", "ChaosProfile", "EventTrace",
    "InvariantChecker", "PROFILES", "ScenarioResult", "Violation",
    "VirtualClock", "get_profile", "run_matrix", "run_scenario",
]
