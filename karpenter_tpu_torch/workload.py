"""Seeded headline workload: the synthetic catalog and pending pods.

The data the reference benchmark solves: the catalog ``bench.py``
builds, through the port's own catalog intake (``cloud/fake.py``'s
IBM-shaped profile ladder and price model, ``catalog/pricing.py``'s
``PricingProvider`` and ``catalog/instancetype.py``'s
``InstanceTypeProvider``: three zones, on-demand plus spot at the 60%
discount, default kubelet overhead, every offering available), and
``bench.py``'s ``build_workload`` pod mix (six size classes; 25% zone
spread, 15% zone pin, 10% on-demand only, 5% tolerating a dedicated
taint).

    pods, catalog = build_workload(10_000, 500, seed=42)

and the windows of the other routes: ``build_hetero_workload`` (the
flat regime: near-unique request shapes), ``affinity_bench_pods`` (the
affinity plane: co-location, anti-affinity and hostname spread menus)
and ``stochastic_pods`` (the stochastic plane: a bounded menu of usage
distributions), copies of ``bench.py``'s ``build_hetero_workload``,
``_affinity_bench_pods`` and the pod menu of ``run_stochastic``; and
``with_preferences``, which gives a window soft preferences (the
soft-preference route below the flat regime).

The same seed gives the same ``CatalogArrays`` fields and the same pods
as the reference, which ``tests/test_torch_workload.py`` checks field by
field.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.apis.pod import (
    HOSTNAME_TOPOLOGY_KEY, PodAffinityTerm, PodSpec, ResourceRequests,
    Toleration, TopologySpreadConstraint, UsageDistribution,
)
from karpenter_tpu_torch.apis.requirements import (
    CAPACITY_TYPE_ON_DEMAND, CAPACITY_TYPE_SPOT, LABEL_CAPACITY_TYPE,
    LABEL_ZONE, Operator, Requirement,
)
from karpenter_tpu_torch.catalog.arrays import CatalogArrays
from karpenter_tpu_torch.catalog.instancetype import InstanceTypeProvider
from karpenter_tpu_torch.catalog.pricing import PricingProvider
from karpenter_tpu_torch.cloud.fake import FakeCloud, generate_profiles
from karpenter_tpu_torch.cloud.fake import profile_price  # noqa: F401 (re-exported)

REGION = "us-south"


# the families of ``bench.run_gang``'s accelerator catalog (gx3 types
# carry a torus)
ACCEL_FAMILIES = ("gx3", "bx2", "cx2", "mx2")


def build_catalog(num_types: int,
                  families: tuple[str, ...] = ("bx2", "cx2", "mx2")
                  ) -> CatalogArrays:
    """The catalog of ``num_types`` synthetic profiles, built as the
    provisioner builds one: the fake cloud's profiles, priced through
    ``PricingProvider`` (its batcher is closed before returning) and
    listed by ``InstanceTypeProvider``."""
    cloud = FakeCloud(profiles=generate_profiles(num_types,
                                                 families=families))
    pricing = PricingProvider(cloud)
    try:
        return CatalogArrays.build(InstanceTypeProvider(cloud,
                                                        pricing).list())
    finally:
        pricing.close()


def build_workload(num_pods: int, num_types: int, seed: int = 42):
    """(pods, catalog): the headline window's pending pods and catalog."""
    catalog = build_catalog(num_types)
    rng = np.random.RandomState(seed)
    sizes = [(250, 512), (500, 1024), (1000, 4096), (2000, 8192),
             (4000, 16384), (8000, 32768)]
    pods = []
    for i in range(num_pods):
        cpu, mem = sizes[rng.randint(len(sizes))]
        kw = {}
        r = rng.rand()
        if r < 0.25:           # topology spread
            kw["topology_spread"] = (TopologySpreadConstraint(max_skew=1),)
        elif r < 0.40:         # zone pin
            kw["node_selector"] = (
                (LABEL_ZONE, f"{REGION}-{rng.randint(3) + 1}"),)
        elif r < 0.50:         # on-demand only
            kw["required_requirements"] = (
                Requirement(LABEL_CAPACITY_TYPE, Operator.IN,
                            (CAPACITY_TYPE_ON_DEMAND,)),)
        elif r < 0.55:         # tolerates a dedicated taint
            kw["tolerations"] = (Toleration("dedicated", "Exists"),)
        pods.append(PodSpec(f"p{i}", requests=ResourceRequests(cpu, mem, 0, 1),
                            **kw))
    return pods, catalog


def build_hetero_workload(num_pods: int, num_types: int, seed: int = 7,
                          constrained_frac: float = 0.0,
                          pref_frac: float = 0.0):
    """(pods, catalog) of the heterogeneous regime: near-unique request
    shapes, so signature compression leaves thousands of groups (the
    flat solver's window).  ``constrained_frac`` adds hard zone pins and
    on-demand limits to that fraction of pods (several label rows);
    ``pref_frac`` adds a soft spot preference."""
    catalog = build_catalog(num_types)
    rng = np.random.RandomState(seed)
    pods = []
    for i in range(num_pods):
        cpu = int(rng.randint(100, 8000))
        mem = int(rng.randint(256, 32768))
        kw = {}
        r = rng.rand()
        if r < constrained_frac * 0.7:
            kw["node_selector"] = ((LABEL_ZONE,
                                    f"{REGION}-{rng.randint(3) + 1}"),)
        elif r < constrained_frac:
            kw["required_requirements"] = (Requirement(
                LABEL_CAPACITY_TYPE, Operator.IN,
                (CAPACITY_TYPE_ON_DEMAND,)),)
        elif r < constrained_frac + pref_frac:
            kw["preferred_requirements"] = ((100, Requirement(
                LABEL_CAPACITY_TYPE, Operator.IN, (CAPACITY_TYPE_SPOT,))),)
        pods.append(PodSpec(f"h{i}",
                            requests=ResourceRequests(cpu, mem, 0, 1),
                            **kw))
    return pods, catalog


def affinity_bench_pods(tag: str, total: int, rng, services: int = 8,
                        spread_sets: int = 4) -> list[PodSpec]:
    """An affinity window: ``services`` anchor/follower pairs with
    required hostname co-location, ``services`` mutual anti pairs and
    ``spread_sets`` self-selecting hostname spread groups (max skew 2),
    padded to ``total`` with signature-collapsing filler drawn from
    ``rng``."""
    sizes = ((500, 1024), (1000, 2048), (2000, 4096), (4000, 8192))
    pods = []
    for s in range(services):
        cpu, mem = sizes[s % len(sizes)]
        req = ResourceRequests(cpu // 4, mem // 4, 0, 1)
        key = f"{tag}-svc{s}"
        pods += [PodSpec(f"{key}-anchor-{i}", requests=req,
                         labels=((key, "anchor"),))
                 for i in range(4)]
        pods += [PodSpec(
            f"{key}-follower-{i}", requests=req,
            affinity=(PodAffinityTerm(
                label_selector=((key, "anchor"),)),))
            for i in range(4)]
        akey = f"{tag}-anti{s}"
        for side, other in (("l", "r"), ("r", "l")):
            pods += [PodSpec(
                f"{akey}-{side}-{i}", requests=req,
                labels=((akey, side),),
                affinity=(PodAffinityTerm(
                    label_selector=((akey, other),), anti=True),))
                for i in range(2)]
    for s in range(spread_sets):
        cpu, mem = sizes[s % len(sizes)]
        skey = f"{tag}-spread{s}"
        pods += [PodSpec(
            f"{skey}-{i}",
            requests=ResourceRequests(cpu // 4, mem // 4, 0, 1),
            labels=((skey, "web"),),
            topology_spread=(TopologySpreadConstraint(
                max_skew=2, topology_key=HOSTNAME_TOPOLOGY_KEY,
                label_selector=((skey, "web"),)),))
            for i in range(6)]
    i = 0
    while len(pods) < total:
        cpu, mem = sizes[rng.randint(len(sizes))]
        pods.append(PodSpec(f"{tag}-fill-{i}",
                            requests=ResourceRequests(cpu, mem, 0, 1)))
        i += 1
    return pods[:total]


def stochastic_pods(num_pods: int, seed: int = 13) -> list[PodSpec]:
    """A stochastic window: requests from four size classes, usage means
    at 40-60% of the request, coefficients of variation 0.15-0.35 — a
    bounded menu, so the distributions group."""
    sizes = ((1000, 2048), (2000, 4096), (4000, 8192), (8000, 16384))
    fracs = (0.4, 0.5, 0.6)
    cvs = (0.15, 0.25, 0.35)
    rng = np.random.RandomState(seed)
    pods = []
    for i in range(num_pods):
        cpu, mem = sizes[rng.randint(len(sizes))]
        frac = fracs[rng.randint(len(fracs))]
        cv = cvs[rng.randint(len(cvs))]
        mcpu, mmem = int(cpu * frac), int(mem * frac)
        usage = UsageDistribution(
            mean=ResourceRequests(mcpu, mmem, 0, 1),
            var=(int((cv * mcpu) ** 2), int((cv * mmem) ** 2), 0, 0))
        pods.append(PodSpec(f"sto{i}",
                            requests=ResourceRequests(cpu, mem, 0, 1),
                            usage=usage))
    return pods


def with_preferences(pods: list[PodSpec]) -> list[PodSpec]:
    """The pods with soft preferences: pod i prefers spot capacity
    (weight 100) when i % 7 == 0 and zone us-south-{i % 3 + 1} (weight
    50) when i % 11 == 0, so pods with both terms miss fractionally."""
    from dataclasses import replace

    out = []
    for i, p in enumerate(pods):
        terms = []
        if i % 7 == 0:
            terms.append((100, Requirement(LABEL_CAPACITY_TYPE, Operator.IN,
                                           (CAPACITY_TYPE_SPOT,))))
        if i % 11 == 0:
            terms.append((50, Requirement(LABEL_ZONE, Operator.IN,
                                          (f"{REGION}-{i % 3 + 1}",))))
        out.append(replace(p, preferred_requirements=tuple(terms))
                   if terms else p)
    return out
