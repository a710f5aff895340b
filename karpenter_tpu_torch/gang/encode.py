"""Host-side gang encoding: pending gang pods -> dense gang tensors
(port of ``karpenter_tpu/gang/encode.py``).

The relational world (requirements, taints, gang membership) is lowered
once on the host into tensors the placement grid consumes:

- ``gang_req``    int64 [Ng, R]  TOTAL resource demand of the gang
                                 (every member lands on one node);
- ``gang_size``   int32 [Ng]     members present in this plan window;
- ``gang_min``    int32 [Ng]     the PodGroup's min_member;
- ``gang_prio``   int32 [Ng]     max member priority;
- ``compat``      bool  [Ng, O]  offering feasibility (labels,
                                 availability, empty-node TOTAL fit);
- per-gang :class:`SliceTable` reference (shared across gangs of one
  shape) for the topology term.

Gangs are ordered priority DESC, then slice chips DESC, then dominant
resource share DESC, then name: the canonical order both planner routes
consume.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from karpenter_tpu_torch.apis.nodeclaim import NodePool
from karpenter_tpu_torch.apis.pod import (
    NUM_RESOURCES, PodSpec, pod_key, tolerates_all,
)
from karpenter_tpu_torch.catalog.arrays import CatalogArrays
from karpenter_tpu_torch.gang.topology import SliceTable, slice_table
from karpenter_tpu_torch.solver.encode import _nozone_compat

_EMPTY_SHAPE: tuple[int, ...] = ()


@dataclass(slots=True)
class GangInfo:
    """One gang's host-side record (names; tensors live on the problem)."""

    name: str
    pod_names: list[str]
    min_member: int
    shape: tuple[int, ...]
    chips: int
    priority: int


@dataclass
class GangProblem:
    """Dense atomic-placement input (see module docstring)."""

    gangs: list[GangInfo]
    gang_req: np.ndarray                 # int64 [Ng, R]
    gang_size: np.ndarray                # int32 [Ng]
    gang_min: np.ndarray                 # int32 [Ng]
    gang_prio: np.ndarray                # int32 [Ng]
    compat: np.ndarray                   # bool  [Ng, O]
    tables: list[SliceTable | None] = field(default_factory=list)  # [Ng]
    catalog: CatalogArrays = None
    rejected: list[str] = field(default_factory=list)   # pod keys

    @property
    def num_gangs(self) -> int:
        return len(self.gangs)


def _member_req(pod: PodSpec) -> np.ndarray:
    req = pod.requests.as_tuple()
    return np.array((req[0], req[1], req[2], max(req[3], 1)), dtype=np.int64)


def encode_gangs(pods: list[PodSpec], catalog: CatalogArrays,
                 nodepool: NodePool | None = None) -> GangProblem:
    """Group pending gang pods by PodGroup name and lower to tensors.

    Pods without a gang are ignored (they belong to the ordinary solve);
    members that do not tolerate the pool's taints reject the WHOLE gang
    (all-or-nothing admission: a gang that cannot fully run here must
    not half-run here).
    """
    nodepool = nodepool or NodePool(name="default")
    by_name: dict[str, list[PodSpec]] = {}
    for p in pods:
        if p.gang is not None:
            by_name.setdefault(p.gang.name, []).append(p)

    gangs: list[GangInfo] = []
    rows_req: list[np.ndarray] = []
    rows_compat: list[np.ndarray] = []
    tables: list[SliceTable | None] = []
    rejected: list[str] = []
    mask_cache: dict = {}
    O = catalog.num_offerings
    for name in by_name:
        members = by_name[name]
        rep = members[0]
        spec = rep.gang
        if nodepool.taints and any(
                not tolerates_all(p.tolerations, nodepool.taints)
                for p in members):
            rejected.extend(pod_key(p) for p in members)
            continue
        total = np.zeros(NUM_RESOURCES, dtype=np.int64)
        for p in members:
            total += _member_req(p)
        reqs = rep.scheduling_requirements().merged(nodepool.requirements)
        compat = _nozone_compat(reqs, tuple(int(v) for v in total),
                                catalog, mask_cache).copy()
        shape = spec.slice_shape or _EMPTY_SHAPE
        table = None
        if shape:
            table = slice_table(catalog, shape)
            compat &= table.count > 0
        gangs.append(GangInfo(
            name=name, pod_names=[pod_key(p) for p in members],
            min_member=spec.min_member, shape=shape,
            chips=spec.chips, priority=max(p.priority for p in members)))
        rows_req.append(total)
        rows_compat.append(compat)
        tables.append(table)

    Ng = len(gangs)
    gang_req = (np.stack(rows_req) if Ng
                else np.zeros((0, NUM_RESOURCES), np.int64))
    compat = (np.stack(rows_compat) if Ng
              else np.zeros((0, O), dtype=bool))
    gang_size = np.array([len(g.pod_names) for g in gangs], dtype=np.int32)
    gang_min = np.array([g.min_member for g in gangs], dtype=np.int32)
    gang_prio = np.array([g.priority for g in gangs], dtype=np.int32)
    if Ng:
        # canonical order: priority DESC, chips DESC, dominant share
        # DESC, name ASC — deterministic, shared by both planner paths
        mean_alloc = catalog.type_alloc.mean(axis=0) if catalog.num_types \
            else np.ones(NUM_RESOURCES)
        shares = np.where(mean_alloc[None, :] > 0,
                          gang_req.astype(np.float64)
                          / np.maximum(mean_alloc, 1e-12)[None, :],
                          0.0).max(axis=1)
        chips = np.array([g.chips for g in gangs], dtype=np.int64)
        order = np.lexsort((np.array([g.name for g in gangs]), -shares,
                            -chips, -gang_prio.astype(np.int64)))
        gangs = [gangs[i] for i in order]
        tables = [tables[i] for i in order]
        gang_req = np.ascontiguousarray(gang_req[order])
        gang_size = np.ascontiguousarray(gang_size[order])
        gang_min = np.ascontiguousarray(gang_min[order])
        gang_prio = np.ascontiguousarray(gang_prio[order])
        compat = np.ascontiguousarray(compat[order])
    return GangProblem(gangs=gangs, gang_req=gang_req, gang_size=gang_size,
                       gang_min=gang_min, gang_prio=gang_prio, compat=compat,
                       tables=tables, catalog=catalog, rejected=rejected)
