"""``TorchSolver`` on the CPU against the reference ``JaxSolver``.

The seeded windows of tests/test_solver.py go through both solvers'
``solve`` (each package encodes its own pods), and through
``solve_encoded`` on one window carried over from the reference
(``karpenter_tpu_torch.carry``), so solver parity does not hang on
encoder parity.  Plans must agree node for node (offering, pods in
order), on unplaced pods and their reasons, and on cost to a relative
1e-5; the port's ``validate_plan`` must come back clean.  Windows that
force node escalation and COO growth, every output mode through
explicit options, and the routes this package does not serve yet
(which must raise NotImplementedError) are covered too.
"""

import numpy as np
import pytest
import torch

import karpenter_tpu.apis.nodeclaim as j_nodeclaim
import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.apis.requirements as j_req
from karpenter_tpu.catalog import (
    CatalogArrays, InstanceTypeProvider, PricingProvider,
)
from karpenter_tpu.cloud.fake import FakeCloud
from karpenter_tpu.solver import JaxSolver, SolverOptions, encode
from karpenter_tpu.solver import SolveRequest as JSolveRequest

import karpenter_tpu_torch.apis.nodeclaim as t_nodeclaim
import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.requirements as t_req
from karpenter_tpu_torch import carry, make_solver
from karpenter_tpu_torch.solver import (
    SolveRequest, SolverOptions as TSolverOptions, TorchSolver,
    validate_plan,
)
from karpenter_tpu_torch.solver import encode as t_encode
from karpenter_tpu_torch.solver.torch_backend import dedup_rows


@pytest.fixture(scope="module")
def jcatalog():
    cloud = FakeCloud()
    pricing = PricingProvider(cloud)
    arrays = CatalogArrays.build(InstanceTypeProvider(cloud, pricing).list())
    pricing.close()
    return arrays


@pytest.fixture(scope="module")
def tcatalog(jcatalog):
    return carry.catalog_from_numpy(
        **{f: getattr(jcatalog, f) for f in carry.CATALOG_FIELDS})


def mixed_specs(n, seed):
    """tests/test_solver.py's seeded_mixed_pods, as plain records."""
    rng = np.random.RandomState(seed)
    sizes = [(250, 512), (500, 1024), (1000, 4096), (2000, 8192),
             (4000, 16384)]
    out = []
    for i in range(n):
        cpu, mem = sizes[rng.randint(len(sizes))]
        r = rng.rand()
        kind = zone = None
        if r < 0.2:
            kind, zone = "zone", f"us-south-{rng.randint(3) + 1}"
        elif r < 0.3:
            kind = "on-demand"
        out.append((f"pod-{i}", cpu, mem, kind, zone))
    return out


def build_pods(specs, pod_mod, req_mod, **extra):
    pods = []
    for name, cpu, mem, kind, zone in specs:
        kw = dict(extra)
        if kind == "zone":
            kw["node_selector"] = ((req_mod.LABEL_ZONE, zone),)
        elif kind == "on-demand":
            kw["required_requirements"] = (req_mod.Requirement(
                req_mod.LABEL_CAPACITY_TYPE, req_mod.Operator.IN,
                ("on-demand",)),)
        pods.append(pod_mod.PodSpec(name, requests=pod_mod.ResourceRequests(
            cpu, mem, 0, 1), **kw))
    return pods


def both(specs, **extra):
    return (build_pods(specs, j_pod, j_req, **extra),
            build_pods(specs, t_pod, t_req, **extra))


def node_view(plan):
    return [(n.instance_type, n.zone, n.capacity_type, n.offering_index,
             n.pod_names) for n in plan.nodes]


def assert_plans_equal(jplan, tplan):
    assert node_view(tplan) == node_view(jplan)
    assert tplan.unplaced_pods == jplan.unplaced_pods
    assert tplan.unplaced_reasons == jplan.unplaced_reasons
    assert tplan.unplaced_words == jplan.unplaced_words
    assert tplan.total_cost_per_hour == pytest.approx(
        jplan.total_cost_per_hour, rel=1e-5)


def jax_solver(**kw):
    return JaxSolver(SolverOptions(use_pallas="off", **kw))


def torch_solver(**kw):
    return TorchSolver(TSolverOptions(**kw), device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 7])
def test_seeded_windows_match_jax(jcatalog, tcatalog, seed):
    jpods, tpods = both(mixed_specs(300, seed))
    jplan = jax_solver().solve(JSolveRequest(jpods, jcatalog))
    ts = torch_solver()
    tplan = ts.solve(SolveRequest(tpods, tcatalog))
    assert_plans_equal(jplan, tplan)
    assert validate_plan(tplan, tpods, tcatalog) == []
    assert ts.last_stats["path"] == "ffd-reference"


def test_unplaced_reasons_match(jcatalog, tcatalog):
    """A window with statically unplaceable and budget-starved pods:
    the device words and the decode refinement agree."""
    specs = mixed_specs(120, 9)
    jpods, tpods = both(specs)
    jpods.append(j_pod.PodSpec("huge", requests=j_pod.ResourceRequests(
        400_000, 8192, 0, 1)))
    tpods.append(t_pod.PodSpec("huge", requests=t_pod.ResourceRequests(
        400_000, 8192, 0, 1)))
    jpods.append(j_pod.PodSpec("nowhere", node_selector=(
        (j_req.LABEL_ZONE, "mars-1"),)))
    tpods.append(t_pod.PodSpec("nowhere", node_selector=(
        (t_req.LABEL_ZONE, "mars-1"),)))
    jplan = jax_solver(max_nodes=64).solve(JSolveRequest(jpods, jcatalog))
    tplan = torch_solver(max_nodes=64).solve(SolveRequest(tpods, tcatalog))
    assert jplan.unplaced_pods
    assert_plans_equal(jplan, tplan)


def test_taint_rejects_match(jcatalog, tcatalog):
    specs = mixed_specs(60, 4)
    jpods, tpods = both(specs)
    jpool = j_nodeclaim.NodePool(
        name="p", taints=(j_pod.Taint("dedicated", "x"),))
    tpool = t_nodeclaim.NodePool(
        name="p", taints=(t_pod.Taint("dedicated", "x"),))
    jplan = jax_solver().solve(JSolveRequest(jpods, jcatalog, jpool))
    tplan = torch_solver().solve(SolveRequest(tpods, tcatalog, tpool))
    assert len(tplan.unplaced_pods) == 60
    assert_plans_equal(jplan, tplan)


def test_carried_window_matches(jcatalog, tcatalog):
    """solve_encoded on a window carried from the reference encoder."""
    jpods, _ = both(mixed_specs(300, 11))
    jprob = encode(jpods, jcatalog)
    tprob = carry.problem_from_numpy(
        tcatalog, group_req=jprob.group_req, group_count=jprob.group_count,
        group_cap=jprob.group_cap, group_prio=jprob.group_prio,
        label_rows=jprob.label_rows, label_idx=jprob.label_idx,
        groups=[{"pod_names": g.pod_names, "pinned_zone": g.pinned_zone,
                 "cap_per_node": g.cap_per_node,
                 "requirements": [(r.key, r.operator.value, r.values)
                                  for r in g.requirements]}
                for g in jprob.groups],
        rejected=jprob.rejected, rejected_reasons=jprob.rejected_reasons)
    assert_plans_equal(jax_solver().solve_encoded(jprob),
                       torch_solver().solve_encoded(tprob))


@pytest.mark.parametrize("compact", ["off", "on"])
@pytest.mark.parametrize("wide_slots", [False, True])
def test_output_modes_match(compact, wide_slots):
    """dense16 / coo16 on the synthetic catalog; dense / COO when one
    offering has >= 2^15 pod slots (int16 packing off).  Both solvers get
    the same explicit options."""
    from karpenter_tpu.catalog.instancetype import (
        InstanceType as JIT, Offering as JOff,
    )
    from karpenter_tpu_torch.catalog import (
        CatalogArrays as TCA, InstanceType as TIT, Offering as TOff,
    )

    def types(IT, Off):
        slots = 40000 if wide_slots else 110
        return [IT(name=f"t{i}-{c}x{c * 4}", cpu_milli=c * 1000,
                   memory_mib=c * 4096, gpu=0, pods=slots,
                   architecture="amd64", family=f"t{i}", size=f"{c}x{c * 4}",
                   offerings=[Off("z1", "on-demand", 0.05 * c),
                              Off("z1", "spot", 0.03 * c)])
                for i, c in enumerate((2, 4, 8, 16))]

    jcat = CatalogArrays.build(types(JIT, JOff))
    tcat = TCA.build(types(TIT, TOff))
    jpods, tpods = both(mixed_specs(150, 3))
    opts = {"compact_assign": compact}
    js, ts = jax_solver(**opts), torch_solver(**opts)
    jplan = js.solve(JSolveRequest(jpods, jcat))
    tplan = ts.solve(SolveRequest(tpods, tcat))
    assert_plans_equal(jplan, tplan)
    assert ts.last_stats["compact"] == (compact == "on")
    assert validate_plan(tplan, tpods, tcat) == []


def test_node_escalation_matches(jcatalog, tcatalog, monkeypatch):
    """The first node axis is too small: all slots open with pods left,
    so the window re-dispatches at 4x N."""
    jpods, tpods = both(mixed_specs(1000, 12))
    monkeypatch.setattr(JaxSolver, "_estimate_nodes",
                        staticmethod(lambda problem, n_cap: 8))
    monkeypatch.setattr(TorchSolver, "_estimate_nodes",
                        staticmethod(lambda problem, n_cap: 8))
    ts = torch_solver()
    tplan = ts.solve(SolveRequest(tpods, tcatalog))
    assert ts.last_stats["escalations"] >= 1
    assert ts.last_stats["N"] > 8
    assert_plans_equal(jax_solver().solve(JSolveRequest(jpods, jcatalog)),
                       tplan)
    assert validate_plan(tplan, tpods, tcatalog) == []


def test_coo_growth_matches(jcatalog, tcatalog, monkeypatch):
    """A COO tail smaller than the nonzero count overflows, grows and
    re-dispatches; the plan equals the reference's."""
    specs = [(f"u{i}", 100 + i, 256, None, None) for i in range(300)]
    jpods, tpods = both(specs)
    monkeypatch.setattr(JaxSolver, "_compact_k",
                        lambda self, total, G: (256, 4096))
    monkeypatch.setattr(TorchSolver, "_compact_k",
                        lambda self, total, G: (256, 4096))
    ts = torch_solver(compact_assign="on", flat_solver="off")
    tplan = ts.solve(SolveRequest(tpods, tcatalog))
    assert ts.last_stats["coo_growths"] >= 1
    jplan = jax_solver(compact_assign="on", flat_solver="off").solve(
        JSolveRequest(jpods, jcatalog))
    assert_plans_equal(jplan, tplan)
    assert validate_plan(tplan, tpods, tcatalog) == []


def test_zone_affinity_window_matches(jcatalog, tcatalog):
    """Zone-affinity groups go through the zone-candidate refinement,
    whose rounds are batched solves in both packages."""
    specs = mixed_specs(80, 6)
    jpods, tpods = both(specs)
    for i in range(12):
        jpods.append(j_pod.PodSpec(f"za{i}", requests=j_pod.ResourceRequests(
            1000, 2048, 0, 1), affinity=(j_pod.PodAffinityTerm(
                (("app", "za"),), j_req.LABEL_ZONE),),
            labels=(("app", "za"),)))
        tpods.append(t_pod.PodSpec(f"za{i}", requests=t_pod.ResourceRequests(
            1000, 2048, 0, 1), affinity=(t_pod.PodAffinityTerm(
                (("app", "za"),), t_req.LABEL_ZONE),),
            labels=(("app", "za"),)))
    jplan = jax_solver().solve(JSolveRequest(jpods, jcatalog))
    ts = torch_solver()
    tplan = ts.solve(SolveRequest(tpods, tcatalog))
    assert_plans_equal(jplan, tplan)
    assert validate_plan(tplan, tpods, tcatalog) == []
    # the last candidate round ran as one batch (solve_encoded_batch)
    assert ts.last_stats["path"] == "ffd-reference-batch"
    assert ts.last_stats["batch"] >= 2


def test_dedup_rows_matches_reference(jcatalog):
    from karpenter_tpu.solver.jax_backend import dedup_rows as j_dedup

    rng = np.random.RandomState(0)
    compat = rng.rand(40, 64) < 0.5
    compat[::3] = compat[0]
    for a, b in zip(dedup_rows(compat), j_dedup(compat)):
        np.testing.assert_array_equal(a, b)


# -- routes this package does not serve yet -----------------------------------


def _unserved_windows(tcatalog):
    base = build_pods(mixed_specs(20, 1), t_pod, t_req)
    pref = base + [t_pod.PodSpec("pref", preferred_requirements=((
        50, t_req.Requirement(t_req.LABEL_CAPACITY_TYPE, t_req.Operator.IN,
                              ("spot",))),))]
    aff = base + [
        t_pod.PodSpec("a", labels=(("app", "a"),)),
        t_pod.PodSpec("b", affinity=(t_pod.PodAffinityTerm(
            (("app", "a"),), t_pod.HOSTNAME_TOPOLOGY_KEY, anti=True),))]
    sto_pool = t_nodeclaim.NodePool(name="oc", overcommit=0.1)
    return {
        "preferences": (SolveRequest(pref, tcatalog), TSolverOptions()),
        "affinity": (SolveRequest(aff, tcatalog), TSolverOptions()),
        "stochastic": (SolveRequest(base, tcatalog, sto_pool),
                       TSolverOptions()),
        "flat": (SolveRequest(base, tcatalog),
                 TSolverOptions(flat_solver="on")),
    }


@pytest.mark.parametrize("route", ["preferences", "affinity", "stochastic",
                                   "flat"])
def test_unserved_route_raises(tcatalog, route):
    request, opts = _unserved_windows(tcatalog)[route]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchSolver(opts, device="cpu").solve(request)


@pytest.mark.parametrize("opts", [{"resident": "on"}, {"serving": "on"},
                                  {"sharded": 2}])
def test_unserved_options_raise(opts):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchSolver(TSolverOptions(**opts), device="cpu")


def test_make_solver_is_unwrapped_torch_solver(jcatalog, tcatalog):
    s = make_solver(TSolverOptions(), device="cpu")
    assert type(s) is TorchSolver
    _, tpods = both(mixed_specs(30, 2))
    plan = s.solve(SolveRequest(tpods, tcatalog))
    assert validate_plan(plan, tpods, tcatalog) == []


def test_encode_is_the_reference_encode(jcatalog, tcatalog):
    jpods, tpods = both(mixed_specs(200, 8))
    jp, tp = encode(jpods, jcatalog), t_encode(tpods, tcatalog)
    for f in ("group_req", "group_count", "group_cap", "group_prio",
              "label_rows", "label_idx"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    assert [g.pod_names for g in tp.groups] == \
        [g.pod_names for g in jp.groups]


def test_cuda_device_is_never_silently_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSolver(TSolverOptions())
