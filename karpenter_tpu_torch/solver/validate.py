"""Independent plan feasibility validator.

Port of ``validate_plan`` from ``karpenter_tpu/solver/validate.py``:
checks a Plan against the raw pods + catalog with no shared code path
with the solver's device half:

- every pod appears exactly once (some node, or unplaced);
- per-node capacity: sum of requests <= allocatable of the node's type;
- per-pod constraints: node labels satisfy the pod's scheduling
  requirements (+ nodepool requirements), offering is available;
- nodepool taints tolerated by every placed pod;
- hostname anti-affinity: <= 1 self-anti pod of one signature per node;
- zone affinity: co-scheduled pods share one zone;
- zone topology spread (DoNotSchedule): skew <= maxSkew over the zones
  the pod set could use;
- gang atomicity: a gang places whole or not at all;
- cost accounting matches the node prices.

On an overcommitting pool the per-node capacity rule is the chance
constraint on the pods' usage distributions
(``stochastic/validate.node_chance_violations``, float64).
"""

from __future__ import annotations

from collections import defaultdict
from collections.abc import Sequence

from karpenter_tpu_torch.apis.nodeclaim import NodePool
from karpenter_tpu_torch.apis.pod import PodSpec, pod_key, tolerates_all
from karpenter_tpu_torch.catalog.arrays import CatalogArrays
from karpenter_tpu_torch.solver.encode import (
    _has_hostname_anti_affinity, _has_zone_affinity, _zone_spread_constraints,
    viable_zones,
)
from karpenter_tpu_torch.solver.types import Plan
from karpenter_tpu_torch.stochastic.validate import node_chance_violations


def validate_plan(plan: Plan, pods: Sequence[PodSpec], catalog: CatalogArrays,
                  nodepool: NodePool | None = None) -> list[str]:
    """Returns a list of violations (empty = feasible)."""
    nodepool = nodepool or NodePool(name="default")
    overcommit = float(getattr(nodepool, "overcommit", 0.0) or 0.0)
    errors: list[str] = []
    by_name: dict[str, PodSpec] = {pod_key(p): p for p in pods}

    # 1. assignment is a partition
    seen: dict[str, str] = {}
    for ni, node in enumerate(plan.nodes):
        for pn in node.pod_names:
            if pn in seen:
                errors.append(f"pod {pn} assigned twice ({seen[pn]} and node{ni})")
            seen[pn] = f"node{ni}"
            if pn not in by_name:
                errors.append(f"pod {pn} not in request")
    for pn in plan.unplaced_pods:
        if pn in seen:
            errors.append(f"pod {pn} both placed and unplaced")
        seen[pn] = "unplaced"
    missing = set(by_name) - set(seen)
    if missing:
        errors.append(f"pods missing from plan: {sorted(missing)[:5]}"
                      f" (+{max(0, len(missing) - 5)} more)")

    # 2. per-node capacity + per-pod constraints
    for ni, node in enumerate(plan.nodes):
        o = node.offering_index
        if o < 0 or o >= catalog.num_offerings:
            errors.append(f"node{ni}: bad offering index {o}")
            continue
        labels = dict(nodepool.labels)
        labels.update(catalog.offering_label_values(o))
        alloc = catalog.offering_alloc()[o]
        if not catalog.off_avail[o]:
            errors.append(f"node{ni}: offering {node.instance_type}/{node.zone}/"
                          f"{node.capacity_type} is blacked out")
        if (node.instance_type, node.zone, node.capacity_type) != \
                catalog.describe_offering(o):
            errors.append(f"node{ni}: offering index mismatch")
        used = [0, 0, 0, 0]
        node_pods: list[PodSpec] = []
        for pn in node.pod_names:
            pod = by_name.get(pn)
            if pod is None:
                continue
            node_pods.append(pod)
            for i, v in enumerate(pod.requests.as_tuple()):
                used[i] += v
            reqs = pod.scheduling_requirements().merged(nodepool.requirements)
            if not reqs.matches(labels):
                errors.append(f"node{ni}: pod {pn} requirements unsatisfied "
                              f"by labels {labels}")
            if nodepool.taints and not tolerates_all(pod.tolerations, nodepool.taints):
                errors.append(f"node{ni}: pod {pn} does not tolerate pool taints")
        if overcommit > 0.0:
            errors.extend(node_chance_violations(
                node_pods, alloc, overcommit,
                label=f"node{ni} ({node.instance_type})"))
        elif any(u > a for u, a in zip(used, alloc)):
            errors.append(f"node{ni} ({node.instance_type}): capacity exceeded "
                          f"used={used} alloc={list(alloc)}")

    # 3. anti-affinity: <=1 self-anti pod of the same signature per node
    for ni, node in enumerate(plan.nodes):
        sig_count: dict[tuple, int] = defaultdict(int)
        for pn in node.pod_names:
            pod = by_name.get(pn)
            if pod is not None and _has_hostname_anti_affinity(pod):
                sig_count[pod.constraint_signature()] += 1
        for sig, c in sig_count.items():
            if c > 1:
                errors.append(f"node{ni}: {c} anti-affinity pods of one group")

    # 4. zone affinity + topology spread, per original signature group
    pod_zone: dict[str, str] = {}
    for node in plan.nodes:
        for pn in node.pod_names:
            pod_zone[pn] = node.zone
    groups: dict[tuple, list[PodSpec]] = defaultdict(list)
    for p in pods:
        groups[p.constraint_signature()].append(p)
    for sig, members in groups.items():
        rep = members[0]
        if rep.gang is not None:
            # gang co-placement supersedes spread: the encoder never
            # zone-splits a gang
            continue
        placed_zones = [pod_zone[pod_key(p)] for p in members if pod_key(p) in pod_zone]
        if not placed_zones:
            continue
        if _has_zone_affinity(rep) and len(set(placed_zones)) > 1:
            errors.append(f"group {rep.name}: zone affinity violated, "
                          f"zones={sorted(set(placed_zones))}")
        for c in _zone_spread_constraints(rep):
            counts = defaultdict(int)
            for z in placed_zones:
                counts[z] += 1
            reqs = rep.scheduling_requirements().merged(nodepool.requirements)
            allowed = viable_zones(reqs, rep.requests.as_tuple(), catalog) \
                or catalog.zones
            values = [counts.get(z, 0) for z in allowed]
            skew = max(values) - min(values)
            if skew > c.max_skew:
                errors.append(f"group {rep.name}: zone skew {skew} > "
                              f"maxSkew {c.max_skew} ({dict(counts)})")

    # 5. gang atomicity (no-partial-gang)
    gangs: dict[str, list[PodSpec]] = defaultdict(list)
    for p in pods:
        if p.gang is not None:
            gangs[p.gang.name].append(p)
    placed_names = {pn for node in plan.nodes for pn in node.pod_names}
    for name, members in gangs.items():
        placed = sum(1 for p in members if pod_key(p) in placed_names)
        if 0 < placed < len(members):
            errors.append(f"gang {name}: partial placement "
                          f"{placed}/{len(members)} members")
        elif placed and placed < members[0].gang.min_member:
            errors.append(f"gang {name}: placed {placed} members below "
                          f"min_member {members[0].gang.min_member}")

    # 6. cost accounting
    expected = sum(n.price for n in plan.nodes)
    if abs(expected - plan.total_cost_per_hour) > 1e-3 * max(1.0, expected):
        errors.append(f"cost mismatch: nodes sum {expected} != "
                      f"plan {plan.total_cost_per_hour}")
    return errors
