"""Independent affinity validator — no shared code with the solver.

Port of ``karpenter_tpu/affinity/validate.py``. The third layer of the
plane (kernel gates -> decode choke -> validator): checks a finished
Plan against the RAW pods, re-deriving every domain from the plan itself
(node identity = planned node, zone identity = the node's zone string).
Nothing here touches the AffinityIndex, the selector classes, or the
enforce pass — a bug in the lowering cannot hide from this file.

Checks:

- required (anti-)affinity per placed pod, kube semantics: for each
  required term, some OTHER pod matching the selector shares the
  topology domain; for each anti term, NO other matching pod shares it
  — and symmetrically, no co-resident pod's anti term matches this pod
  (anti-affinity disjointness);
- hostname topology spread (DoNotSchedule): per node, pods matching
  the constraint's selector stay within ``max_skew``; an empty
  selector self-selects the carrier's signature group (the documented
  cap lowering).

Gang members are exempt from their OWN terms (gang atomicity
supersedes affinity/spread at the decode choke, docs/design/gang.md),
but still count toward other pods' domains — the same census-only
semantics the choke applies.

Zone-scope spread keeps its legacy validator
(``solver/validate.validate_plan`` section 4 — skew over viable
zones); this file owns everything the affinity plane added.
"""

from __future__ import annotations

from collections import defaultdict
from collections.abc import Sequence

from karpenter_tpu_torch.apis.pod import (
    HOSTNAME_TOPOLOGY_KEY, ZONE_TOPOLOGY_KEY, PodSpec, pod_key,
)
from karpenter_tpu_torch.solver.types import Plan


def _matches(selector, labels_dict) -> bool:
    return bool(selector) \
        and all(labels_dict.get(k) == v for k, v in selector)


def validate_affinity_plan(plan: Plan, pods: Sequence[PodSpec]
                           ) -> list[str]:
    """Returns a list of violations (empty = the plan honors every
    affinity term and hostname spread bound)."""
    errors: list[str] = []
    by_name: dict[str, PodSpec] = {pod_key(p): p for p in pods}

    # domain membership, straight from the plan
    node_pods: list[list[PodSpec]] = []
    zone_pods: dict[str, list[PodSpec]] = defaultdict(list)
    for node in plan.nodes:
        members = [by_name[pn] for pn in node.pod_names if pn in by_name]
        node_pods.append(members)
        zone_pods[node.zone].extend(members)

    def _domain_violations(members: list[PodSpec], scope: str,
                           label: str) -> None:
        labels = [p.labels_dict for p in members]
        for i, p in enumerate(members):
            if p.gang is not None:
                continue        # gang supersedes (census-only)
            others = [labels[j] for j in range(len(members)) if j != i]
            for t in p.affinity:
                if t.topology_key != scope:
                    continue
                hit = any(_matches(t.label_selector, lab)
                          for lab in others)
                if t.anti and hit:
                    errors.append(
                        f"{label}: pod {pod_key(p)} anti-affinity "
                        f"{dict(t.label_selector)} violated by a "
                        f"co-resident matching pod")
                if not t.anti and not hit:
                    errors.append(
                        f"{label}: pod {pod_key(p)} required affinity "
                        f"{dict(t.label_selector)} has no matching "
                        f"co-resident pod")

    for ni, members in enumerate(node_pods):
        _domain_violations(members, HOSTNAME_TOPOLOGY_KEY, f"node{ni}")
    for zone in sorted(zone_pods):
        _domain_violations(zone_pods[zone], ZONE_TOPOLOGY_KEY,
                           f"zone {zone}")

    # hostname spread bounds, re-counted from raw pods per node
    for ni, members in enumerate(node_pods):
        for p in members:
            if p.gang is not None:
                continue        # gang supersedes (census-only)
            for c in p.topology_spread:
                if c.topology_key != HOSTNAME_TOPOLOGY_KEY \
                        or c.when_unsatisfiable != "DoNotSchedule":
                    continue
                if c.label_selector:
                    n = sum(1 for q in members
                            if _matches(c.label_selector, q.labels_dict))
                else:
                    sig = p.constraint_signature()
                    n = sum(1 for q in members
                            if q.constraint_signature() == sig)
                if n > c.max_skew:
                    errors.append(
                        f"node{ni}: hostname spread bound "
                        f"{c.max_skew} exceeded ({n} matching pods, "
                        f"selector {dict(c.label_selector)})")
    return errors
