"""Independent plan feasibility validators.

Port of ``validate_plan``, ``validate_gang_plan``,
``validate_preemption_plan`` and ``validate_repack_plan`` from
``karpenter_tpu/solver/validate.py`` (the gang, preemption and repack
checks are listed on their functions).
``validate_plan`` checks a Plan against the raw pods + catalog with no
shared code path with the solver's device half:

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


def validate_gang_plan(plan, pods: Sequence[PodSpec], catalog: CatalogArrays,
                       nodepool: NodePool | None = None) -> list[str]:
    """Independent feasibility oracle for a :class:`gang.types.GangPlan`
    — no shared code path with either planner backend.  Checks against
    the raw gang pods + catalog:

    - every gang is placed WHOLE on exactly one node (atomicity), with
      at least ``min_member`` members present, or fully unplaced;
    - slice geometry: each assignment's placement bitmask has exactly
      ``chips`` bits, lies within the node type's torus, and is one of
      the enumerated contiguous placements; assignments sharing a node
      are pairwise chip-disjoint;
    - per-node capacity: total member demand fits the offering's
      allocatable; offering is available and label-compatible with the
      members' scheduling requirements; pool taints tolerated;
    - cost accounting matches the node prices.
    """
    import math

    from karpenter_tpu_torch.gang.topology import (
        mask_chips, type_placements,
    )

    nodepool = nodepool or NodePool(name="default")
    errors: list[str] = []
    by_name: dict[str, PodSpec] = {pod_key(p): p for p in pods}
    members_of: dict[str, set[str]] = defaultdict(set)
    spec_of: dict[str, object] = {}
    for p in pods:
        if p.gang is not None:
            members_of[p.gang.name].add(pod_key(p))
            spec_of[p.gang.name] = p.gang

    placed_of: dict[str, set[str]] = defaultdict(set)
    node_of: dict[str, set[int]] = defaultdict(set)
    seen: set[str] = set()
    for ni, node in enumerate(plan.nodes):
        o = node.offering_index
        if o < 0 or o >= catalog.num_offerings:
            errors.append(f"node{ni}: bad offering index {o}")
            continue
        if not catalog.off_avail[o]:
            errors.append(f"node{ni}: offering {node.instance_type}/"
                          f"{node.zone}/{node.capacity_type} is blacked out")
        if (node.instance_type, node.zone, node.capacity_type) != \
                catalog.describe_offering(o):
            errors.append(f"node{ni}: offering index mismatch")
        t = int(catalog.off_type[o])
        labels = dict(nodepool.labels)
        labels.update(catalog.offering_label_values(o))
        alloc = catalog.offering_alloc()[o]
        used = [0, 0, 0, 0]
        occupied = 0
        for a in node.assignments:
            spec = spec_of.get(a.gang)
            if spec is None:
                errors.append(f"node{ni}: assignment for unknown gang "
                              f"{a.gang}")
                continue
            placed_of[a.gang].update(a.pod_names)
            node_of[a.gang].add(ni)
            if spec.slice_shape:
                want = math.prod(spec.slice_shape)
                if mask_chips(a.placement_mask) != want:
                    errors.append(f"node{ni}: gang {a.gang} mask has "
                                  f"{mask_chips(a.placement_mask)} chips, "
                                  f"shape needs {want}")
                if a.placement_mask not in type_placements(
                        catalog, t, spec.slice_shape):
                    errors.append(f"node{ni}: gang {a.gang} mask is not a "
                                  f"contiguous {spec.slice_shape} placement "
                                  f"on {node.instance_type}'s torus")
                if a.placement_mask & occupied:
                    errors.append(f"node{ni}: gang {a.gang} slice overlaps "
                                  f"another gang's chips")
                occupied |= a.placement_mask
                # rank-aware assignment: the rank->chip map must be a
                # bijection onto exactly the slice's chips, and the
                # claimed max hop must match an independent recount
                # over the torus geometry (and never exceed the
                # provable optimum for the block)
                if a.rank_chips:
                    from karpenter_tpu_torch.gang.topology import (
                        _block_dims, max_hop_of_chips, optimal_max_hop,
                    )

                    torus = tuple(catalog.type_torus[t]) \
                        if t < len(catalog.type_torus) else ()
                    mask_bits = {c for c in range(64)
                                 if (a.placement_mask >> c) & 1}
                    if set(a.rank_chips) != mask_bits \
                            or len(a.rank_chips) != len(mask_bits):
                        errors.append(
                            f"node{ni}: gang {a.gang} rank assignment is "
                            f"not a bijection onto the slice's chips")
                    else:
                        recount = max_hop_of_chips(torus, a.rank_chips)
                        if recount != a.max_hop:
                            errors.append(
                                f"node{ni}: gang {a.gang} claims max hop "
                                f"{a.max_hop}, recount says {recount}")
                        bound = optimal_max_hop(
                            _block_dims(torus, a.placement_mask))
                        if recount > bound:
                            errors.append(
                                f"node{ni}: gang {a.gang} rank assignment "
                                f"hop {recount} exceeds the optimal bound "
                                f"{bound} for its block")
            for pn in a.pod_names:
                if pn in seen:
                    errors.append(f"pod {pn} assigned twice")
                seen.add(pn)
                pod = by_name.get(pn)
                if pod is None:
                    errors.append(f"pod {pn} not in request")
                    continue
                for i, v in enumerate(pod.requests.as_tuple()):
                    used[i] += v if i != 3 else max(v, 1)
                reqs = pod.scheduling_requirements().merged(
                    nodepool.requirements)
                if not reqs.matches(labels):
                    errors.append(f"node{ni}: pod {pn} requirements "
                                  f"unsatisfied by labels")
                if nodepool.taints and not tolerates_all(pod.tolerations,
                                                         nodepool.taints):
                    errors.append(f"node{ni}: pod {pn} does not tolerate "
                                  f"pool taints")
        if any(u > a_ for u, a_ in zip(used, alloc)):
            errors.append(f"node{ni} ({node.instance_type}): capacity "
                          f"exceeded used={used} alloc={list(alloc)}")

    for name, members in members_of.items():
        placed = placed_of.get(name, set())
        if not placed:
            continue
        if placed != members:
            errors.append(f"gang {name}: partial placement "
                          f"{len(placed)}/{len(members)} members")
        if len(node_of[name]) > 1:
            errors.append(f"gang {name}: members split across "
                          f"{len(node_of[name])} nodes")
        if len(placed) < spec_of[name].min_member:
            errors.append(f"gang {name}: placed below min_member "
                          f"{spec_of[name].min_member}")
    for pn in plan.unplaced:
        if pn in seen:
            errors.append(f"pod {pn} both placed and unplaced")

    expected = sum(n.price for n in plan.nodes)
    if abs(expected - plan.total_cost_per_hour) > 1e-3 * max(1.0, expected):
        errors.append(f"cost mismatch: nodes sum {expected} != "
                      f"plan {plan.total_cost_per_hour}")
    return errors


def validate_preemption_plan(plan, pending_pods: Sequence[PodSpec], cluster,
                             catalog: CatalogArrays,
                             nodepool: NodePool | None = None,
                             occupancy: dict | None = None) -> list[str]:
    """Independent feasibility oracle for a PreemptionPlan — no shared
    code path with either planner backend.  Checks against ground truth
    (cluster claims + bound pods + catalog):

    - every eviction names a live claim and a pod actually occupying it;
      no pod is evicted twice, or both evicted and placed;
    - **no priority inversion**: every victim's priority is strictly
      below the lowest priority among the pods the plan places on that
      claim (and below the recorded beneficiary priority);
    - per-claim capacity: surviving occupants + placements fit the
      claim's offering allocatable;
    - placed pods come from the pending request, each placed once, their
      scheduling requirements are satisfied by the target's offering
      labels (availability deliberately NOT required — the node exists)
      and they tolerate the claim's and pool's taints.
    """
    from karpenter_tpu_torch.preempt.encode import (
        claim_pods, occupancy_index,
    )

    nodepool = nodepool or NodePool(name="default")
    errors: list[str] = []
    by_name: dict[str, PodSpec] = {pod_key(p): p for p in pending_pods}
    claims = {c.name: c for c in cluster.nodeclaims()
              if not c.deleted and c.launched}
    if occupancy is None:
        occupancy = occupancy_index(cluster)

    evicted: dict[str, str] = {}           # pod key -> claim
    for ev in plan.evictions:
        claim = claims.get(ev.claim_name)
        if claim is None:
            errors.append(f"eviction {ev.pod_key}: unknown/dead claim "
                          f"{ev.claim_name}")
            continue
        occupants = {pod_key(p.spec): p
                     for p in claim_pods(cluster, claim, index=occupancy)}
        if ev.pod_key not in occupants:
            errors.append(f"eviction {ev.pod_key}: pod not on claim "
                          f"{ev.claim_name}")
        elif occupants[ev.pod_key].spec.priority != ev.victim_priority:
            errors.append(f"eviction {ev.pod_key}: recorded priority "
                          f"{ev.victim_priority} != actual "
                          f"{occupants[ev.pod_key].spec.priority}")
        if ev.pod_key in evicted:
            errors.append(f"pod {ev.pod_key} evicted twice")
        evicted[ev.pod_key] = ev.claim_name
        if ev.victim_priority >= ev.beneficiary_priority:
            errors.append(
                f"priority inversion: victim {ev.pod_key} (prio "
                f"{ev.victim_priority}) evicted for beneficiary prio "
                f"{ev.beneficiary_priority}")

    placed_by_claim: dict[str, list[str]] = {}
    seen: set[str] = set()
    for pn, claim_name in plan.placements.items():
        if pn in seen:
            errors.append(f"pod {pn} placed twice")
        seen.add(pn)
        if pn in evicted:
            errors.append(f"pod {pn} both placed and evicted")
        if pn not in by_name:
            errors.append(f"placed pod {pn} not in the pending request")
        if claim_name not in claims:
            errors.append(f"pod {pn} placed on unknown claim {claim_name}")
            continue
        placed_by_claim.setdefault(claim_name, []).append(pn)

    for claim_name, placed in placed_by_claim.items():
        claim = claims[claim_name]
        o = catalog.find_offering(claim.instance_type, claim.zone,
                                  claim.capacity_type)
        if o is None:
            errors.append(f"claim {claim_name}: offering "
                          f"{claim.instance_type}/{claim.zone} not in catalog")
            continue
        labels = dict(nodepool.labels)
        labels.update(catalog.offering_label_values(o))
        alloc = catalog.offering_alloc()[o]
        used = [0, 0, 0, 0]
        # surviving occupants keep their footprint
        for p in claim_pods(cluster, claim, index=occupancy):
            key = pod_key(p.spec)
            if evicted.get(key) == claim_name:
                continue
            for i, v in enumerate(p.spec.requests.as_tuple()):
                used[i] += v if i != 3 else max(v, 1)
        max_placed_prio = None
        for pn in placed:
            pod = by_name.get(pn)
            if pod is None:
                continue
            for i, v in enumerate(pod.requests.as_tuple()):
                used[i] += v if i != 3 else max(v, 1)
            max_placed_prio = pod.priority if max_placed_prio is None \
                else max(max_placed_prio, pod.priority)
            reqs = pod.scheduling_requirements().merged(nodepool.requirements)
            if not reqs.matches(labels):
                errors.append(f"claim {claim_name}: pod {pn} requirements "
                              f"unsatisfied by labels")
            if claim.taints and not tolerates_all(pod.tolerations,
                                                  claim.taints):
                errors.append(f"claim {claim_name}: pod {pn} does not "
                              f"tolerate claim taints")
            if nodepool.taints and not tolerates_all(pod.tolerations,
                                                     nodepool.taints):
                errors.append(f"claim {claim_name}: pod {pn} does not "
                              f"tolerate pool taints")
        if any(u > a for u, a in zip(used, alloc)):
            errors.append(f"claim {claim_name} ({claim.instance_type}): "
                          f"capacity exceeded used={used} "
                          f"alloc={list(alloc)}")
        # independent inversion check: recompute from the placements,
        # not the plan's own beneficiary stamps.  Every victim must have
        # yielded to SOME strictly-higher-priority pod placed on the
        # claim (the max, not the min: lower-priority pods may ride
        # along into leftover slack without evicting anyone).
        if max_placed_prio is not None:
            for ev in plan.evictions:
                if ev.claim_name == claim_name \
                        and ev.victim_priority >= max_placed_prio:
                    errors.append(
                        f"claim {claim_name}: victim {ev.pod_key} (prio "
                        f"{ev.victim_priority}) >= placed max prio "
                        f"{max_placed_prio}")

    # evictions that freed capacity nothing uses are waste, not a
    # feasibility violation — but an eviction on a claim with NO
    # placements at all serves nobody and is flagged
    for ev in plan.evictions:
        if ev.claim_name in claims and ev.claim_name not in placed_by_claim:
            errors.append(f"eviction {ev.pod_key} on claim {ev.claim_name} "
                          f"serves no placement")
    return errors


def validate_repack_plan(plan, cluster, catalog: CatalogArrays,
                         nodepool: NodePool | None = None,
                         occupancy: dict | None = None) -> list[str]:
    """Independent feasibility oracle for a RepackPlan — no shared code
    path with either planner backend.  Checks against ground truth
    (cluster claims + occupant pods + catalog + torus geometry), BEFORE
    actuation:

    - every migration names a live source claim and a pod actually
      occupying it; no pod moves twice; never onto its own node, never
      onto a drained node; gang members never move (atomic co-location
      is the gang plane's invariant);
    - **no pod dropped**: every occupant of a drained claim is migrated
      somewhere;
    - per-target capacity: surviving occupants + arrivals fit the
      target's offering allocatable; requirements/taints/zone pins hold
      against the target (availability deliberately NOT required — the
      node exists);
    - **claimed slices actually reopened**: each ReopenedSlice's
      occupancy evidence matches the canonical chip model re-derived
      from ground truth, and the shape truly fits the vacated torus but
      not the occupied one — geometry re-enumerated from the type's
      torus dims, independent of the planner's SliceTable cache.
    """
    from karpenter_tpu_torch.gang.topology import enumerate_placements
    from karpenter_tpu_torch.preempt.encode import claim_pods, occupancy_index
    from karpenter_tpu_torch.repack.encode import PodRef, chip_layout

    _hha = _has_hostname_anti_affinity

    nodepool = nodepool or NodePool(name="default")
    errors: list[str] = []
    claims = {c.name: c for c in cluster.nodeclaims()
              if not c.deleted and c.launched}
    if occupancy is None:
        occupancy = occupancy_index(cluster)
    drained = set(plan.drained)

    def _occupants(claim):
        return {pod_key(p.spec): p
                for p in claim_pods(cluster, claim, index=occupancy)}

    moved: dict[str, str] = {}
    arrivals: dict[str, list] = defaultdict(list)
    for m in plan.migrations:
        src = claims.get(m.src_claim)
        dst = claims.get(m.dst_claim)
        if src is None:
            errors.append(f"migration {m.pod_key}: unknown/dead source "
                          f"claim {m.src_claim}")
            continue
        if dst is None:
            errors.append(f"migration {m.pod_key}: unknown/dead target "
                          f"claim {m.dst_claim}")
            continue
        if m.src_claim == m.dst_claim:
            errors.append(f"migration {m.pod_key}: onto its own node")
        if m.dst_claim in drained:
            errors.append(f"migration {m.pod_key}: onto drained claim "
                          f"{m.dst_claim}")
        occupants = _occupants(src)
        if m.pod_key not in occupants:
            errors.append(f"migration {m.pod_key}: pod not on claim "
                          f"{m.src_claim}")
            continue
        if m.pod_key in moved:
            errors.append(f"pod {m.pod_key} migrated twice")
        moved[m.pod_key] = m.dst_claim
        spec = occupants[m.pod_key].spec
        if spec.gang is not None:
            errors.append(f"migration {m.pod_key}: gang member moved "
                          f"(breaks atomic co-location of "
                          f"{spec.gang.name})")
        if (_has_zone_affinity(spec) or _zone_spread_constraints(spec)) \
                and dst.zone != src.zone:
            errors.append(f"migration {m.pod_key}: zone-pinned pod moved "
                          f"{src.zone} -> {dst.zone}")
        if _hha(spec):
            errors.append(f"migration {m.pod_key}: hostname-anti-affinity "
                          f"pod moved (conservatively immovable)")
        arrivals[m.dst_claim].append(spec)

    for name in plan.drained:
        claim = claims.get(name)
        if claim is None:
            errors.append(f"drain of unknown/dead claim {name}")
            continue
        for key in _occupants(claim):
            if key not in moved:
                errors.append(f"drained claim {name} still hosts {key} "
                              f"(pod dropped)")

    for claim_name, specs in arrivals.items():
        claim = claims[claim_name]
        o = catalog.find_offering(claim.instance_type, claim.zone,
                                  claim.capacity_type)
        if o is None:
            errors.append(f"target {claim_name}: offering "
                          f"{claim.instance_type}/{claim.zone} not in "
                          f"catalog")
            continue
        labels = dict(nodepool.labels)
        labels.update(catalog.offering_label_values(o))
        alloc = catalog.offering_alloc()[o]
        used = [0, 0, 0, 0]
        for key, p in _occupants(claim).items():
            if moved.get(key) is not None and moved[key] != claim_name:
                continue   # departing occupant frees its footprint
            for i, v in enumerate(p.spec.requests.as_tuple()):
                used[i] += v if i != 3 else max(v, 1)
        for spec in specs:
            for i, v in enumerate(spec.requests.as_tuple()):
                used[i] += v if i != 3 else max(v, 1)
            reqs = spec.scheduling_requirements().merged(
                nodepool.requirements)
            if not reqs.matches(labels):
                errors.append(f"target {claim_name}: pod "
                              f"{pod_key(spec)} requirements unsatisfied "
                              f"by labels")
            if claim.taints and not tolerates_all(spec.tolerations,
                                                  claim.taints):
                errors.append(f"target {claim_name}: pod {pod_key(spec)} "
                              f"does not tolerate claim taints")
            if nodepool.taints and not tolerates_all(spec.tolerations,
                                                     nodepool.taints):
                errors.append(f"target {claim_name}: pod {pod_key(spec)} "
                              f"does not tolerate pool taints")
        if any(u > a for u, a in zip(used, alloc)):
            errors.append(f"target {claim_name} ({claim.instance_type}): "
                          f"capacity exceeded used={used} "
                          f"alloc={list(alloc)}")

    seen_slices: set[tuple] = set()
    for r in plan.reopened:
        claim = claims.get(r.claim_name)
        if claim is None:
            errors.append(f"reopened slice on unknown/dead claim "
                          f"{r.claim_name}")
            continue
        if r.claim_name in drained:
            errors.append(f"reopened slice on DRAINED claim "
                          f"{r.claim_name}")
        if (r.claim_name, r.shape) in seen_slices:
            errors.append(f"slice {r.shape} on {r.claim_name} reopened "
                          f"twice")
        seen_slices.add((r.claim_name, r.shape))
        o = catalog.find_offering(claim.instance_type, claim.zone,
                                  claim.capacity_type)
        if o is None or o != r.offering:
            errors.append(f"reopened slice on {r.claim_name}: recorded "
                          f"offering {r.offering} != actual {o}")
            continue
        # re-derive the canonical chip model from ground truth
        t = int(catalog.off_type[o])
        torus = tuple(catalog.type_torus[t]) if t < len(catalog.type_torus) \
            else ()
        refs, gang_shapes, seen_gangs = [], [], set()
        for p in claim_pods(cluster, claim, index=occupancy):
            spec = p.spec
            gpu = int(spec.requests.gpu)
            in_gang = spec.gang is not None
            movable = not in_gang and not _hha(spec) \
                and tolerates_all(spec.tolerations, tuple(nodepool.taints))
            ref = PodRef(key=pod_key(spec), req=None, sig=0, gpu=gpu,
                         movable=movable, single=movable and gpu > 0)
            if in_gang and spec.gang.slice_shape:
                if spec.gang.name not in seen_gangs:
                    seen_gangs.add(spec.gang.name)
                    gang_shapes.append((spec.gang.name,
                                        tuple(spec.gang.slice_shape)))
                ref.chip_mask = -1
            refs.append(ref)
        occ, sing = chip_layout(refs, gang_shapes, torus)
        if r.pre_mask != occ:
            errors.append(f"reopened slice on {r.claim_name}: recorded "
                          f"pre-occupancy {r.pre_mask:#x} != ground truth "
                          f"{occ:#x}")
        if r.post_mask != (occ & ~sing):
            errors.append(f"reopened slice on {r.claim_name}: recorded "
                          f"post-occupancy {r.post_mask:#x} != vacated "
                          f"ground truth {occ & ~sing:#x}")
        fits_pre = fits_post = False
        for mask in enumerate_placements(torus, tuple(r.shape)):
            if (mask & r.pre_mask) == 0:
                fits_pre = True
            if (mask & r.post_mask) == 0:
                fits_post = True
        if fits_pre:
            errors.append(f"slice {r.shape} on {r.claim_name} already fit "
                          f"the occupied torus (nothing reopened)")
        if not fits_post:
            errors.append(f"slice {r.shape} on {r.claim_name} does NOT "
                          f"fit the vacated torus (claimed reopening is "
                          f"false)")
    return errors
