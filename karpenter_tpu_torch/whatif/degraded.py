"""Degraded mode of the what-if plane: the scenario-at-a-time host loop
(port of ``karpenter_tpu/whatif/degraded.py``).

The contract of every plane's Resilient* wrapper (solver, preempt, gang,
repack, sharded): a stacked solve that raises (a faulted device, an
out-of-memory stack, a failed ``ffd_scan_fleet`` launch) degrades to the
numpy oracle loop (``WhatIfPlanner.plan_host``) with an
``ERRORS{whatif, degraded_<exception type>}`` sample and the
``host-degraded`` backend tag, never an exception into the planning
tick.  The host loop gives the same result words up to the float cost
word.  A planner on the card never hands its plan to the host
(``device.holds_card``): the failure raises.
"""

from __future__ import annotations

from karpenter_tpu_torch.device import holds_card
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger
from karpenter_tpu_torch.whatif.planner import WhatIfPlan, WhatIfPlanner

log = get_logger("whatif.degraded")


class ResilientPlanner:
    """Wraps :class:`WhatIfPlanner`: the stacked plan, the host loop
    after a failure of a planner on the CPU.  ``device`` (the
    reference's flag) False plans on the host alone; a planner built
    here runs on ``planner_device``."""

    def __init__(self, planner: WhatIfPlanner | None = None,
                 device: bool = True, planner_device="cuda"):
        self.planner = planner or WhatIfPlanner(device=planner_device)
        self.device = device
        self.degraded_plans = 0

    def plan(self, baseline, scenarios) -> WhatIfPlan:
        if self.device:
            try:
                return self.planner.plan(baseline, scenarios)
            except Exception as e:  # noqa: BLE001 — the degraded contract:
                # any failure of the stacked solve falls to the host loop
                kind = type(e).__name__
                if holds_card(self.planner):
                    log.error("whatif device plan failed on the card",
                              error=str(e)[:200], kind=kind)
                    raise
                log.warning("whatif device plan failed; degrading to the "
                            "host loop", error=str(e)[:200], kind=kind)
                metrics.ERRORS.labels("whatif", f"degraded_{kind}").inc()
        plan = self.planner.plan_host(baseline, scenarios)
        self.degraded_plans += 1
        plan.backend = "host-degraded" if self.device else "host"
        return plan


__all__ = ["ResilientPlanner"]
