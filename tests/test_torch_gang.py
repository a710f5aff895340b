"""The gang plane of the port against the reference's.

Seeded gang windows in the shape of ``bench.run_gang`` (mixed slice
shapes 4x4 / 2x2x2 / 2x2 / none over an accelerator catalog), cut to a
few gangs, go through both packages: the port's ``encode_gangs`` must
give the reference's tensors and slice tables, and the port's planner,
on the numpy route, forced onto the torch route and on its own size
rule, must give the reference planner's plan (nodes, assignments, rank
orders, hops, unplaced gangs, cost) on a problem carried over from the
reference (``carry.gang_problem_from_numpy``).  The port's
``validate_gang_plan`` must come back clean and catch a partial gang.
The full ``bench.run_gang`` shape (64 gangs x 16 members, 500 types) is
the ``slow`` case.
"""

import numpy as np
import pytest
import torch

import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.apis.podgroup as j_pg
from karpenter_tpu.catalog import (
    CatalogArrays, InstanceTypeProvider, PricingProvider,
)
from karpenter_tpu.cloud.fake import FakeCloud, generate_profiles
from karpenter_tpu.gang import GangOptions as JGangOptions
from karpenter_tpu.gang import GangPlanner as JGangPlanner
from karpenter_tpu.gang import encode_gangs as j_encode_gangs

import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.podgroup as t_pg
from karpenter_tpu_torch import carry
from karpenter_tpu_torch.gang import (
    GangOptions, GangPlanner, encode_gangs,
)
from karpenter_tpu_torch.gang import planner as t_planner
from karpenter_tpu_torch.solver.validate import validate_gang_plan


def accel_catalog(num_types):
    cloud = FakeCloud(profiles=generate_profiles(
        num_types, families=("gx3", "bx2", "cx2", "mx2")))
    pricing = PricingProvider(cloud)
    arrays = CatalogArrays.build(InstanceTypeProvider(cloud, pricing).list())
    pricing.close()
    return arrays


def port_catalog(jcat):
    return carry.catalog_from_numpy(
        type_torus=jcat.type_torus,
        **{f: getattr(jcat, f) for f in carry.CATALOG_FIELDS})


@pytest.fixture(scope="module")
def catalogs():
    jcat = accel_catalog(40)
    return jcat, port_catalog(jcat)


def gang_specs(num_gangs, members, seed):
    """``bench.run_gang``'s gangs as plain records."""
    rng = np.random.RandomState(seed)
    shapes = ["4x4", "2x2x2", "2x2", ""]
    out = []
    for g in range(num_gangs):
        shape = shapes[int(rng.randint(len(shapes)))]
        reqs = [(int(rng.randint(100, 500)), int(rng.randint(256, 1024)))
                for _ in range(members)]
        out.append((f"job-{g:03d}", shape, reqs))
    return out


def build_pods(specs, pod_mod, pg_mod, short=()):
    """Pods of both packages; gangs named in ``short`` present one member
    fewer than their ``min_member``."""
    pods = []
    for name, shape, reqs in specs:
        gang = pg_mod.PodGroup(name=name, min_member=len(reqs),
                               slice_shape=shape or None)
        n = len(reqs) - (1 if name in short else 0)
        for m, (cpu, mem) in enumerate(reqs[:n]):
            pods.append(pod_mod.PodSpec(
                f"{name}-{m}", requests=pod_mod.ResourceRequests(cpu, mem,
                                                                 0, 1),
                gang=gang))
    return pods


def carried(jprob, tcat):
    return carry.gang_problem_from_numpy(
        tcat, gangs=[{"name": g.name, "pod_names": g.pod_names,
                      "min_member": g.min_member, "shape": g.shape,
                      "chips": g.chips, "priority": g.priority}
                     for g in jprob.gangs],
        gang_req=jprob.gang_req, gang_size=jprob.gang_size,
        gang_min=jprob.gang_min, gang_prio=jprob.gang_prio,
        compat=jprob.compat, rejected=jprob.rejected)


def fingerprint(plan):
    return (plan.placements, plan.placed_gangs, plan.unplaced_gangs,
            plan.unplaced, plan.total_cost_per_hour,
            [(n.offering_index, n.instance_type, n.zone, n.capacity_type,
              n.price, [(a.gang, a.placement_mask, a.pod_names,
                         a.rank_chips, a.max_hop) for a in n.assignments])
             for n in plan.nodes])


def window(catalogs, seed, num_gangs=12, members=4):
    jcat, tcat = catalogs
    specs = gang_specs(num_gangs, members, seed)
    short = (specs[1][0],)
    jpods = build_pods(specs, j_pod, j_pg, short)
    tpods = build_pods(specs, t_pod, t_pg, short)
    return jpods, tpods, j_encode_gangs(jpods, jcat)


@pytest.mark.parametrize("seed", [17, 3])
def test_encode_matches_reference(catalogs, seed):
    jcat, tcat = catalogs
    _, tpods, jprob = window(catalogs, seed)
    tprob = encode_gangs(tpods, tcat)
    assert [(g.name, g.pod_names, g.min_member, g.shape, g.chips,
             g.priority) for g in tprob.gangs] == \
        [(g.name, g.pod_names, g.min_member, g.shape, g.chips, g.priority)
         for g in jprob.gangs]
    for name in ("gang_req", "gang_size", "gang_min", "gang_prio",
                 "compat"):
        np.testing.assert_array_equal(getattr(tprob, name),
                                      getattr(jprob, name), err_msg=name)
    for tt, jt in zip(tprob.tables, jprob.tables):
        assert (tt is None) == (jt is None)
        if tt is not None:
            for name in ("masks", "valid", "count", "hops"):
                np.testing.assert_array_equal(getattr(tt, name),
                                              getattr(jt, name))


@pytest.mark.parametrize("use_device", ["off", "on", "auto"])
@pytest.mark.parametrize("seed", [17, 3])
def test_plan_matches_reference(catalogs, seed, use_device):
    jcat, tcat = catalogs
    _, tpods, jprob = window(catalogs, seed)
    want = JGangPlanner(JGangOptions(use_device="off")).plan(jprob)
    planner = GangPlanner(GangOptions(use_device=use_device), device="cpu")
    got = planner.plan(carried(jprob, tcat))
    assert fingerprint(got) == fingerprint(want)
    assert got.unplaced_gangs, "the short gang must stay unplaced"
    # the size rule: this window's grids are below _DEVICE_MIN_CELLS
    assert (planner.device_steps > 0) == (use_device == "on")
    assert validate_gang_plan(got, tpods, tcat) == []
    # the port's own encode plans the same
    own = GangPlanner(GangOptions(use_device=use_device),
                      device="cpu").plan(encode_gangs(tpods, tcat))
    assert fingerprint(own) == fingerprint(got)


def test_auto_takes_the_torch_grid_from_its_size(catalogs, monkeypatch):
    jcat, tcat = catalogs
    _, _, jprob = window(catalogs, 17)
    want = GangPlanner(GangOptions(use_device="off"),
                       device="cpu").plan(carried(jprob, tcat))
    monkeypatch.setattr(t_planner, "_DEVICE_MIN_CELLS", 2)
    planner = GangPlanner(GangOptions(use_device="auto"), device="cpu")
    assert fingerprint(planner.plan(carried(jprob, tcat))) == \
        fingerprint(want)
    assert planner.device_steps > 0


def test_validator_catches_a_partial_gang(catalogs):
    jcat, tcat = catalogs
    _, tpods, jprob = window(catalogs, 17)
    plan = GangPlanner(GangOptions(use_device="on"),
                       device="cpu").plan(carried(jprob, tcat))
    node = next(n for n in plan.nodes if n.assignments)
    a = node.assignments[0]
    node.assignments[0] = type(a)(
        gang=a.gang, placement_mask=a.placement_mask,
        pod_names=a.pod_names[:-1], rank_chips=a.rank_chips,
        max_hop=a.max_hop)
    errors = validate_gang_plan(plan, tpods, tcat)
    assert any("partial placement" in e for e in errors)


def test_torch_grid_failure_raises(catalogs, monkeypatch):
    """No fallback: a failing torch grid fails the plan."""
    jcat, tcat = catalogs
    _, _, jprob = window(catalogs, 17)

    def broken(*a, **k):
        raise RuntimeError("grid failed")

    monkeypatch.setattr(t_planner, "free_grid_torch", broken)
    with pytest.raises(RuntimeError, match="grid failed"):
        GangPlanner(GangOptions(use_device="on"),
                    device="cpu").plan(carried(jprob, tcat))


def test_port_accelerator_catalog_is_the_reference_catalog():
    """``workload.build_catalog(n, ACCEL_FAMILIES)`` (the chip run's gang
    catalog) equals the fake cloud's catalog of ``bench.run_gang``."""
    from karpenter_tpu_torch import workload
    from tests.test_torch_workload import assert_catalogs_equal

    assert_catalogs_equal(accel_catalog(60),
                          workload.build_catalog(60,
                                                 workload.ACCEL_FAMILIES))


def test_default_planner_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GangPlanner()


@pytest.mark.slow
def test_full_size_plan_matches_reference():
    """``bench.run_gang``'s shape: 64 gangs x 16 members, 500 types."""
    jcat = accel_catalog(500)
    tcat = port_catalog(jcat)
    specs = gang_specs(64, 16, 17)
    jpods = build_pods(specs, j_pod, j_pg)
    tpods = build_pods(specs, t_pod, t_pg)
    jprob = j_encode_gangs(jpods, jcat)
    want = JGangPlanner(JGangOptions(use_device="off")).plan(jprob)
    for use in ("off", "on"):
        got = GangPlanner(GangOptions(use_device=use),
                          device="cpu").plan(encode_gangs(tpods, tcat))
        assert fingerprint(got) == fingerprint(want)
        assert validate_gang_plan(got, tpods, tcat) == []
