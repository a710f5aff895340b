"""Fleet-scale solves and device meshes (port of ``karpenter_tpu/parallel``).

``fleet_solve_packed`` solves C cluster problems, each with its own
catalog, in one device program around one launch of the fleet FFD
kernel.  The mesh half spreads that work over the slots of a mesh
(``mesh.py``): the fleet axis over clusters (``fleet_solve``,
``fleet_solve_pallas_sharded``) and the offer axis over one cluster's
catalog (``fleet_solve_sharded_offerings``, ``sharded_solve_core``),
combined by the collectives of ``collectives.py``.  The reference's
``shard_map`` shim over JAX's own API has no counterpart.
"""

from karpenter_tpu_torch.parallel.fleet import (
    CooCapacity, FleetProblem, fleet_device_catalog, fleet_pack_inputs,
    fleet_parse_outputs, fleet_solve, fleet_solve_packed,
    fleet_solve_pallas_sharded, fleet_solve_sharded_offerings,
    sharded_solve_core,
)
from karpenter_tpu_torch.parallel.mesh import (
    FLEET_AXIS, OFFER_AXIS, SHARD_AXIS, Mesh, fleet_mesh, shard_mesh,
    solver_mesh,
)

__all__ = [
    "fleet_mesh", "shard_mesh", "solver_mesh", "Mesh", "FLEET_AXIS",
    "OFFER_AXIS", "SHARD_AXIS", "CooCapacity", "FleetProblem",
    "fleet_device_catalog", "fleet_pack_inputs", "fleet_parse_outputs",
    "fleet_solve", "fleet_solve_packed", "fleet_solve_pallas_sharded",
    "fleet_solve_sharded_offerings", "sharded_solve_core",
]
