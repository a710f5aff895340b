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
- :mod:`validate` — well-formedness of every perturbed state and the
  equality of each scenario's words with a fresh single-window solve.

The planning service, the arrival forecaster and the command line of the
reference wait for the host surface (ROADMAP queue 1 item 12), and its
scenario-at-a-time fallback for item 13: here a failed stacked solve
raises.
"""

from __future__ import annotations

import os

# scenarios per stacked solve: a larger menu runs in ceil(K / max)
# chunks rather than as one stacked buffer that could exhaust the card
WHATIF_MAX_K = max(1, int(os.environ.get("KARPENTER_WHATIF_MAX_K", "128")))

# staleness heuristic: expected seconds per retry window when estimating
# how long an unplaced backlog takes to drain (planner.ScenarioOutcome)
WHATIF_RETRY_S = 15.0

from karpenter_tpu_torch.whatif.planner import (  # noqa: E402
    ScenarioOutcome, WhatIfPlan, WhatIfPlanner, build_baseline,
)
from karpenter_tpu_torch.whatif.scenario import (  # noqa: E402
    ArrivalWave, CapClamp, OfferingMask, PreProvision, Scenario,
    WhatIfBaseline, lower_scenarios,
)
from karpenter_tpu_torch.whatif.validate import validate_whatif  # noqa: E402

__all__ = [
    "WHATIF_MAX_K", "WHATIF_RETRY_S", "ArrivalWave", "CapClamp",
    "OfferingMask", "PreProvision", "Scenario", "ScenarioOutcome",
    "WhatIfBaseline", "WhatIfPlan", "WhatIfPlanner", "build_baseline",
    "lower_scenarios", "validate_whatif",
]
