"""The preemption plane of the port against the reference's.

Seeded overload windows in the shape of ``bench.run_preempt`` (every
node full with three low-priority victims, pending demand of mixed
sizes and priorities), cut to a few hundred pods, are built as cluster
state in both packages from the same records.  The port's
``encode_victims`` and ``group_node_compat`` must give the reference's
tensors; the port's planner, on the numpy route, forced onto the torch
route and on its own size rule, must give the reference planner's
evictions, placements and unplaced pods, on the port's own encoding and
on victims carried over from the reference
(``carry.victims_from_numpy``); the int32 guard keeps a tensor past
int32 on the numpy route.  The port's ``validate_preemption_plan`` must
come back clean and catch a priority inversion.  The full
``bench.run_preempt`` shape (10k pending, 2000 claims) is the ``slow``
case.
"""

import numpy as np
import pytest
import torch

import bench
import karpenter_tpu.apis.nodeclaim as j_nodeclaim
import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.core.cluster as j_cluster
from karpenter_tpu.preempt import PlannerOptions as JPlannerOptions
from karpenter_tpu.preempt import PreemptionPlanner as JPreemptionPlanner
from karpenter_tpu.preempt import encode_victims as j_encode_victims
from karpenter_tpu.preempt import group_node_compat as j_group_node_compat
from karpenter_tpu.solver.encode import encode as j_encode

import karpenter_tpu_torch.apis.nodeclaim as t_nodeclaim
import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.core.cluster as t_cluster
from karpenter_tpu_torch import carry
from karpenter_tpu_torch.preempt import (
    PlannerOptions, PreemptionPlanner, encode_victims, group_node_compat,
)
from karpenter_tpu_torch.preempt import planner as t_planner
from karpenter_tpu_torch.solver.encode import encode as t_encode
from karpenter_tpu_torch.solver.validate import validate_preemption_plan


def overload_records(catalog, num_claims, num_pending, seed):
    """``bench.run_preempt``'s cluster and pending pods as plain records:
    claims (name, type, zone), victims (name, cpu, mem, prio, claim),
    pending (name, cpu, mem, prio)."""
    rng = np.random.RandomState(seed)
    alloc = catalog.type_alloc
    hostable = [t for t in range(catalog.num_types)
                if alloc[t, 0] >= 2000 and alloc[t, 1] >= 4096]
    claims, victims = [], []
    for i in range(num_claims):
        t = hostable[rng.randint(len(hostable))]
        claims.append((f"pc{i}", catalog.type_names[t],
                       catalog.zones[rng.randint(len(catalog.zones))]))
        for j in range(3):
            victims.append((f"v{i}-{j}", int(alloc[t, 0] * 0.32),
                            int(alloc[t, 1] * 0.32),
                            int(rng.choice([0, 0, 0, 100])), f"pc{i}"))
    sizes = [(500, 1024), (1000, 2048), (2000, 4096)]
    prios = [0, 0, 100, 100, 100, 1000]
    pending = []
    for k in range(num_pending):
        cpu, mem = sizes[rng.randint(len(sizes))]
        pending.append((f"p{k}", cpu, mem, prios[rng.randint(len(prios))]))
    return claims, victims, pending


def build_side(records, pod_mod, nc_mod, cl_mod):
    """(cluster, pending pods) of one package from the records."""
    claims, victims, pending = records
    cluster = cl_mod.ClusterState()
    for name, itype, zone in claims:
        cluster.add_nodeclaim(nc_mod.NodeClaim(
            name=name, instance_type=itype,
            zone=zone, node_name=f"node-{name}", launched=True))
    for name, cpu, mem, prio, claim in victims:
        cluster.add_pod(pod_mod.PodSpec(
            name, requests=pod_mod.ResourceRequests(cpu, mem, 0, 1),
            priority=prio))
        cluster.bind_pod(f"default/{name}", f"node-{claim}")
    pods = [pod_mod.PodSpec(name, requests=pod_mod.ResourceRequests(
        cpu, mem, 0, 1), priority=prio) for name, cpu, mem, prio in pending]
    return cluster, pods


@pytest.fixture(scope="module")
def catalogs():
    jcat = bench.build_catalog(40)
    tcat = carry.catalog_from_numpy(
        **{f: getattr(jcat, f) for f in carry.CATALOG_FIELDS})
    return jcat, tcat


def window(catalogs, seed, num_claims=60, num_pending=300):
    jcat, tcat = catalogs
    rec = overload_records(jcat, num_claims, num_pending, seed)
    jcl, jpods = build_side(rec, j_pod, j_nodeclaim, j_cluster)
    tcl, tpods = build_side(rec, t_pod, t_nodeclaim, t_cluster)
    jprob = j_encode(jpods, jcat)
    jvict = j_encode_victims(jcl, jcat)
    jcompat = j_group_node_compat(jprob, jvict)
    return (jcl, jpods, jprob, jvict, jcompat), (tcl, tpods)


def carried_victims(jv):
    return carry.victims_from_numpy(
        claims=[{"name": c.name, "instance_type": c.instance_type,
                 "zone": c.zone, "capacity_type": c.capacity_type,
                 "node_name": c.node_name,
                 "taints": [(t.key, t.value, t.effect) for t in c.taints]}
                for c in jv.claims],
        node_off=jv.node_off, resid=jv.resid, vict_keys=jv.vict_keys,
        vict_prio=jv.vict_prio, vict_count=jv.vict_count,
        freed_prefix=jv.freed_prefix)


def carried_problem(jprob, tcat):
    return carry.problem_from_numpy(
        tcat, group_req=jprob.group_req, group_count=jprob.group_count,
        group_cap=jprob.group_cap, group_prio=jprob.group_prio,
        label_rows=jprob.label_rows, label_idx=jprob.label_idx,
        groups=[{"pod_names": g.pod_names} for g in jprob.groups])


def fingerprint(plan):
    return ([(e.claim_name, e.pod_key, e.victim_priority,
              e.beneficiary_priority, e.beneficiary)
             for e in plan.evictions],
            plan.placements, plan.unplaced, plan.eviction_weight,
            plan.candidate_count)


@pytest.mark.parametrize("seed", [31, 5])
def test_victims_and_compat_match_reference(catalogs, seed):
    jcat, tcat = catalogs
    (_, _, jprob, jv, jcompat), (tcl, tpods) = window(catalogs, seed)
    tv = encode_victims(tcl, tcat)
    assert tv.claim_names == jv.claim_names
    assert tv.vict_keys == jv.vict_keys
    for name in ("node_off", "resid", "vict_prio", "vict_count",
                 "freed_prefix"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name),
                                      err_msg=name)
    tprob = t_encode(tpods, tcat)
    np.testing.assert_array_equal(group_node_compat(tprob, tv), jcompat)


@pytest.mark.parametrize("use_device", ["off", "on", "auto"])
@pytest.mark.parametrize("seed", [31, 5])
def test_plan_matches_reference(catalogs, seed, use_device):
    jcat, tcat = catalogs
    (_, _, jprob, jv, jcompat), (tcl, tpods) = window(catalogs, seed)
    budget = 60 * 3
    want = JPreemptionPlanner(JPlannerOptions(
        use_device="off", max_evictions=budget)).plan(jprob, jv, jcompat)
    assert want.evictions and want.placements and want.unplaced
    opts = PlannerOptions(use_device=use_device, max_evictions=budget)
    planner = PreemptionPlanner(opts, device="cpu")
    got = planner.plan(carried_problem(jprob, tcat), carried_victims(jv),
                       jcompat)
    assert fingerprint(got) == fingerprint(want)
    # the size rule: 60 claims x 4 prefixes is below _DEVICE_MIN_CELLS
    assert (planner.device_steps > 0) == (use_device == "on")
    assert validate_preemption_plan(got, tpods, tcl, tcat) == []
    own = PreemptionPlanner(opts, device="cpu").plan(
        t_encode(tpods, tcat), encode_victims(tcl, tcat))
    assert fingerprint(own) == fingerprint(got)


def test_auto_takes_the_torch_grid_from_its_size(catalogs, monkeypatch):
    jcat, tcat = catalogs
    (_, _, jprob, jv, jcompat), _ = window(catalogs, 31)
    want = PreemptionPlanner(PlannerOptions(use_device="off"),
                             device="cpu").plan(carried_problem(jprob, tcat),
                                                carried_victims(jv), jcompat)
    monkeypatch.setattr(t_planner, "_DEVICE_MIN_CELLS", 2)
    planner = PreemptionPlanner(PlannerOptions(use_device="auto"),
                                device="cpu")
    got = planner.plan(carried_problem(jprob, tcat), carried_victims(jv),
                       jcompat)
    assert fingerprint(got) == fingerprint(want)
    assert planner.device_steps > 0


def test_int32_guard_keeps_wide_tensors_on_numpy(catalogs):
    """A node whose residual passes int32 cannot go through the int32
    torch grid: even forced on, that plan runs the numpy grid."""
    jcat, tcat = catalogs
    (_, _, jprob, jv, jcompat), _ = window(catalogs, 31)
    tv = carried_victims(jv)
    tv.resid[0, 1] += np.int64(1) << 33
    want = PreemptionPlanner(PlannerOptions(use_device="off"),
                             device="cpu").plan(carried_problem(jprob, tcat),
                                                tv, jcompat)
    planner = PreemptionPlanner(PlannerOptions(use_device="on"),
                                device="cpu")
    got = planner.plan(carried_problem(jprob, tcat), tv, jcompat)
    assert planner.device_steps == 0
    assert fingerprint(got) == fingerprint(want)


def test_validator_catches_priority_inversion(catalogs):
    jcat, tcat = catalogs
    _, (tcl, tpods) = window(catalogs, 31)
    plan = PreemptionPlanner(PlannerOptions(use_device="on"),
                             device="cpu").plan(t_encode(tpods, tcat),
                                                encode_victims(tcl, tcat))
    ev = plan.evictions[0]
    plan.evictions[0] = type(ev)(
        claim_name=ev.claim_name, pod_key=ev.pod_key,
        victim_priority=ev.victim_priority,
        beneficiary_priority=ev.victim_priority,
        beneficiary=ev.beneficiary)
    errors = validate_preemption_plan(plan, tpods, tcl, tcat)
    assert any("priority inversion" in e for e in errors)


def test_torch_grid_failure_raises(catalogs, monkeypatch):
    """No fallback: a failing torch grid fails the plan."""
    jcat, tcat = catalogs
    _, (tcl, tpods) = window(catalogs, 31)

    def broken(*a, **k):
        raise RuntimeError("grid failed")

    monkeypatch.setattr(t_planner, "fit_grid_torch", broken)
    with pytest.raises(RuntimeError, match="grid failed"):
        PreemptionPlanner(PlannerOptions(use_device="on"),
                          device="cpu").plan(t_encode(tpods, tcat),
                                             encode_victims(tcl, tcat))


def test_default_planner_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PreemptionPlanner()


@pytest.mark.slow
def test_full_size_plan_matches_reference(catalogs):
    """``bench.run_preempt``'s shape: 10k pending, 2000 claims, 500
    types, seed 31; the torch grid on its own size rule."""
    jcat = bench.build_catalog(500)
    tcat = carry.catalog_from_numpy(
        **{f: getattr(jcat, f) for f in carry.CATALOG_FIELDS})
    rec = overload_records(jcat, 2000, 10_000, 31)
    jcl, jpods = build_side(rec, j_pod, j_nodeclaim, j_cluster)
    tcl, tpods = build_side(rec, t_pod, t_nodeclaim, t_cluster)
    jprob = j_encode(jpods, jcat)
    jv = j_encode_victims(jcl, jcat)
    opts = dict(max_evictions=2000 * 3)
    want = JPreemptionPlanner(JPlannerOptions(use_device="off", **opts)
                              ).plan(jprob, jv)
    planner = PreemptionPlanner(PlannerOptions(use_device="auto", **opts),
                                device="cpu")
    got = planner.plan(t_encode(tpods, tcat), encode_victims(tcl, tcat))
    assert planner.device_steps > 0
    assert fingerprint(got) == fingerprint(want)
    assert validate_preemption_plan(got, tpods, tcl, tcat) == []
