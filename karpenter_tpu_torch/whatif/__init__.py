"""What-if scenario planning: K futures of one pending window in one
stacked solve (port of ``karpenter_tpu/whatif``).

- :mod:`scenario` — perturbations of the packed baseline (arrival
  waves, offering masks from chaos knobs, cap clamps), each lowered to a
  word delta through ``resident/delta``, so K scenarios ship as one
  stacked ``[K, D]`` pair on one baseline buffer;
- :mod:`kernels` — the stacked solve: the deltas applied into K copies
  of the baseline, then ONE fleet-kernel launch with a shared catalog
  (``solve_packed_batch_torch``) and one cost-sum launch;
- :mod:`planner` — ``build_baseline``, the planner (chunked above
  ``WHATIF_MAX_K``) and the per-scenario decode;
- :mod:`oracle` — the numpy twin of the stacked solve;
- :mod:`degraded` — ``ResilientPlanner``: a failed stacked solve of a
  planner on the CPU degrades to the scenario-at-a-time host loop
  (``plan_host``; one on the card raises);
- :mod:`validate` — well-formedness of every perturbed state and the
  equality of each scenario's words with a fresh single-window solve;
- :mod:`forecast` — arrival rates per signature group and a diurnal
  profile from the ledger's arrival table, saved in the journal;
- :mod:`service` — ``PlanningService`` (the standing menu in one stacked
  plan, recommendations ranked by risk averted per dollar, the audit
  registry) and its ``WhatIfController``; ``python -m
  karpenter_tpu_torch.whatif --determinism`` runs its seeded cycle twice.
"""

from __future__ import annotations

import os

# scenarios per stacked solve: a larger menu runs in ceil(K / max)
# chunks rather than as one stacked buffer that could exhaust the card
WHATIF_MAX_K = max(1, int(os.environ.get("KARPENTER_WHATIF_MAX_K", "128")))

# default planning horizon (virtual hours) and service cadence
WHATIF_HORIZON_HOURS = 4
WHATIF_INTERVAL_S = 60.0

# the longest horizon an evaluation accepts (one week): a larger one
# would run an unbounded forecast loop and stack under the single flight
WHATIF_MAX_HORIZON_HOURS = 168

# staleness heuristic: expected seconds per retry window when estimating
# how long an unplaced backlog takes to drain (planner.ScenarioOutcome)
WHATIF_RETRY_S = 15.0

from karpenter_tpu_torch.whatif.forecast import ArrivalForecaster  # noqa: E402
from karpenter_tpu_torch.whatif.planner import (  # noqa: E402
    ScenarioOutcome, WhatIfPlan, WhatIfPlanner, build_baseline,
)
from karpenter_tpu_torch.whatif.scenario import (  # noqa: E402
    ArrivalWave, CapClamp, OfferingMask, PreProvision, Scenario,
    WhatIfBaseline, lower_scenarios,
)
from karpenter_tpu_torch.whatif.degraded import ResilientPlanner  # noqa: E402
from karpenter_tpu_torch.whatif.service import PlanningService  # noqa: E402
from karpenter_tpu_torch.whatif.validate import validate_whatif  # noqa: E402

__all__ = [
    "WHATIF_MAX_K", "WHATIF_HORIZON_HOURS", "WHATIF_INTERVAL_S",
    "WHATIF_RETRY_S", "ArrivalForecaster", "ArrivalWave", "CapClamp",
    "OfferingMask", "PreProvision", "Scenario", "lower_scenarios",
    "WhatIfBaseline", "WhatIfPlan", "WhatIfPlanner", "ScenarioOutcome",
    "build_baseline", "ResilientPlanner", "PlanningService",
    "validate_whatif",
]
