"""Carry the reference's state into the port: catalog, encoded window, and
the inputs of the what-if, gang and preemption planes.

The state of this system is the offering catalog and the encoded solve
window, not weights.  These builders take the reference's objects handed
over as numpy arrays and plain records (never the objects themselves —
this package imports nothing of ``karpenter_tpu``) and build the port's
``CatalogArrays``, ``EncodedProblem``, ``WhatIfBaseline``,
``GangProblem`` and ``VictimSet``, so a comparison can run both packages
on the very same input without depending on the two encoders agreeing.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from karpenter_tpu_torch.apis.pod import PodSpec, ResourceRequests
from karpenter_tpu_torch.apis.requirements import (
    Operator, Requirement, Requirements,
)
from karpenter_tpu_torch.catalog.arrays import CatalogArrays
from karpenter_tpu_torch.solver.encode import BIG_CAP, EncodedProblem, PodGroup

CATALOG_FIELDS = ("type_names", "type_alloc", "type_arch", "type_family",
                  "type_size", "off_type", "off_zone", "off_cap",
                  "off_price", "off_avail", "zones", "archs", "families",
                  "sizes")


def catalog_from_numpy(*, type_names: Sequence[str], type_alloc, type_arch,
                       type_family, type_size, off_type, off_zone, off_cap,
                       off_price, off_avail, zones: Sequence[str],
                       archs: Sequence[str], families: Sequence[str],
                       sizes: Sequence[str], type_torus=(), off_risk=None,
                       generation: int = 0,
                       availability_generation=None) -> CatalogArrays:
    """A port ``CatalogArrays`` from the reference catalog's fields (the
    names of ``CATALOG_FIELDS``), copied, with a fresh cache uid."""
    from karpenter_tpu_torch.catalog.arrays import CAPACITY_TYPES, _uid_counter

    off_type = np.array(off_type, dtype=np.int32)
    off_zone = np.array(off_zone, dtype=np.int32)
    off_cap = np.array(off_cap, dtype=np.int32)
    type_names = list(type_names)
    zones = list(zones)
    index = {(type_names[t], zones[z], CAPACITY_TYPES[c]): o
             for o, (t, z, c) in enumerate(zip(off_type.tolist(),
                                               off_zone.tolist(),
                                               off_cap.tolist()))}
    return CatalogArrays(
        type_names=type_names,
        type_alloc=np.array(type_alloc, dtype=np.int32),
        type_arch=np.array(type_arch, dtype=np.int32),
        type_family=np.array(type_family, dtype=np.int32),
        type_size=np.array(type_size, dtype=np.int32),
        off_type=off_type, off_zone=off_zone, off_cap=off_cap,
        off_price=np.array(off_price, dtype=np.float32),
        off_avail=np.array(off_avail, dtype=bool),
        zones=zones, archs=list(archs), families=list(families),
        sizes=list(sizes), type_torus=[tuple(t) for t in type_torus],
        off_risk=None if off_risk is None
        else np.array(off_risk, dtype=np.float32),
        generation=generation,
        availability_generation=availability_generation,
        uid=next(_uid_counter), _offering_index=index)


def _requirements(records) -> Requirements:
    """[(key, operator, values)] -> Requirements."""
    return Requirements([Requirement(k, Operator(op), tuple(v))
                         for k, op, v in records])


def problem_from_numpy(catalog: CatalogArrays, *, group_req, group_count,
                       group_cap, label_rows, label_idx, groups: Sequence[dict],
                       group_prio=None, group_gang=None, group_min=None,
                       gang_names: Sequence[str] = (),
                       rejected: Sequence[str] = (),
                       rejected_reasons: dict | None = None,
                       compat=None) -> EncodedProblem:
    """A port ``EncodedProblem`` from the reference's dense columns.

    ``groups`` holds one plain record per group row: ``pod_names``
    (list), and optionally ``requirements`` ([(key, operator, values)]),
    ``pinned_zone`` and ``cap_per_node``.  The representative pod is
    rebuilt from the group's request row.  No affinity, preference or
    stochastic leaf is carried: the port serves those routes, but a
    window that needs one is built by each package's own encoder."""
    group_req = np.array(group_req, dtype=np.int32).reshape(-1, 4)
    pgroups = []
    for gi, rec in enumerate(groups):
        names = list(rec["pod_names"])
        req = group_req[gi]
        ns, _, name = names[0].rpartition("/")
        rep = PodSpec(name, namespace=ns or "default",
                      requests=ResourceRequests(int(req[0]), int(req[1]),
                                                int(req[2]), int(req[3])))
        pgroups.append(PodGroup(
            representative=rep, pod_names=names, count=len(names),
            requirements=_requirements(rec.get("requirements", ())),
            cap_per_node=int(rec.get("cap_per_node", BIG_CAP)),
            pinned_zone=rec.get("pinned_zone")))
    return EncodedProblem(
        groups=pgroups, group_req=group_req,
        group_count=np.array(group_count, dtype=np.int32),
        group_cap=np.array(group_cap, dtype=np.int32),
        compat=None if compat is None else np.array(compat, dtype=bool),
        catalog=catalog, rejected=list(rejected),
        label_rows=None if label_rows is None
        else np.array(label_rows, dtype=bool),
        label_idx=None if label_idx is None
        else np.array(label_idx, dtype=np.int32),
        group_prio=None if group_prio is None
        else np.array(group_prio, dtype=np.int32),
        group_gang=None if group_gang is None
        else np.array(group_gang, dtype=np.int32),
        group_min=None if group_min is None
        else np.array(group_min, dtype=np.int32),
        gang_names=list(gang_names),
        rejected_reasons=dict(rejected_reasons or {}))


def baseline_from_numpy(problem: EncodedProblem, *, packed, G_pad: int,
                        O_pad: int, U_pad: int, pods: int = 0):
    """A port ``WhatIfBaseline`` from the reference baseline's packed
    buffer and pads; ``problem`` is the carried window
    (:func:`problem_from_numpy`, with ``group_gang``), whose catalog the
    baseline takes."""
    from karpenter_tpu_torch.whatif.scenario import WhatIfBaseline

    return WhatIfBaseline(problem=problem,
                          packed=np.array(packed, dtype=np.int32),
                          G_pad=int(G_pad), O_pad=int(O_pad),
                          U_pad=int(U_pad), catalog=problem.catalog,
                          pods=int(pods))


def gang_problem_from_numpy(catalog: CatalogArrays, *,
                            gangs: Sequence[dict], gang_req, gang_size,
                            gang_min, gang_prio, compat,
                            rejected: Sequence[str] = ()):
    """A port ``GangProblem`` from the reference's gang tensors.
    ``gangs`` holds one record per gang row, in the problem's order:
    ``name``, ``pod_names``, ``min_member``, ``shape``, ``chips`` and
    ``priority``.  The slice tables are rebuilt from the port's catalog
    (pure geometry of the carried tori)."""
    from karpenter_tpu_torch.gang.encode import GangInfo, GangProblem
    from karpenter_tpu_torch.gang.topology import slice_table

    infos = [GangInfo(name=g["name"], pod_names=list(g["pod_names"]),
                      min_member=int(g["min_member"]),
                      shape=tuple(int(v) for v in g["shape"]),
                      chips=int(g["chips"]), priority=int(g["priority"]))
             for g in gangs]
    return GangProblem(
        gangs=infos,
        gang_req=np.array(gang_req, dtype=np.int64).reshape(-1, 4),
        gang_size=np.array(gang_size, dtype=np.int32),
        gang_min=np.array(gang_min, dtype=np.int32),
        gang_prio=np.array(gang_prio, dtype=np.int32),
        compat=np.array(compat, dtype=bool).reshape(len(infos), -1),
        tables=[slice_table(catalog, g.shape) if g.shape else None
                for g in infos],
        catalog=catalog, rejected=list(rejected))


def victims_from_numpy(*, claims: Sequence[dict], node_off, resid,
                       vict_keys: Sequence[Sequence[str]], vict_prio,
                       vict_count, freed_prefix):
    """A port ``VictimSet`` from the reference's victim tensors.
    ``claims`` holds one record per victim node, in the set's order:
    ``name``, ``instance_type``, ``zone``, ``capacity_type``,
    ``node_name`` and ``taints`` ([(key, value, effect)])."""
    from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
    from karpenter_tpu_torch.apis.pod import Taint
    from karpenter_tpu_torch.preempt.encode import VictimSet

    objs = [NodeClaim(name=c["name"], instance_type=c["instance_type"],
                      zone=c["zone"], capacity_type=c["capacity_type"],
                      node_name=c.get("node_name", ""),
                      taints=tuple(Taint(*t) for t in c.get("taints", ())),
                      launched=True)
            for c in claims]
    return VictimSet(
        claim_names=[c.name for c in objs], claims=objs,
        node_off=np.array(node_off, dtype=np.int32),
        resid=np.array(resid, dtype=np.int64).reshape(len(objs), -1),
        vict_keys=[list(k) for k in vict_keys],
        vict_prio=np.array(vict_prio, dtype=np.int32).reshape(len(objs), -1),
        vict_count=np.array(vict_count, dtype=np.int32),
        freed_prefix=np.array(freed_prefix, dtype=np.int64).reshape(
            len(objs), -1, 4))
