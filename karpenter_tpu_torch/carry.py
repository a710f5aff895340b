"""Carry the reference's state into the port: catalog and encoded window.

The state of this system is the offering catalog and the encoded solve
window, not weights.  These builders take the reference's objects handed
over as numpy arrays and plain records (never the objects themselves —
this package imports nothing of ``karpenter_tpu``) and build the port's
``CatalogArrays`` and ``EncodedProblem``, so a solver comparison can run
both packages on the very same window without depending on the two
encoders agreeing.
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
    rebuilt from the group's request row; the window must carry no
    affinity, preference or stochastic columns (the routes this package
    does not serve)."""
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
