"""Multi-cluster fleet solves on one card (port of ``karpenter_tpu/parallel``).

Only the single-device fleet is ported: C cluster problems, each with its
own catalog, in one device program around one launch of the fleet FFD
kernel.  The mesh variants of the reference need more than one device.
"""

from karpenter_tpu_torch.parallel.fleet import (
    CooCapacity, FleetProblem, fleet_device_catalog, fleet_pack_inputs,
    fleet_parse_outputs, fleet_solve_packed,
)

__all__ = [
    "CooCapacity", "FleetProblem", "fleet_device_catalog",
    "fleet_pack_inputs", "fleet_parse_outputs", "fleet_solve_packed",
]
