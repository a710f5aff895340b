"""The repack plane and the resident occupancy view of the port against
the reference's.

Seeded fleets in the shape of ``tests/test_repack.py``'s random worlds
(small, large and accelerator claims over two zones, gpu singletons,
some taints and tolerations, a parked 2x2x2 gang on odd seeds) and its
torus-defrag world are built as cluster state in both packages from the
same records, over the reference's catalog carried into the port.  The
port's ``encode_repack`` must give the reference's tensors; its planner,
on the numpy route and forced onto the torch route, must give the
reference planner's plan on the same route (migrations, drains, reopened
slices, cost), and the port's ``validate_repack_plan`` must come back
clean and flag what the reference's flags.  The occupancy rows of the
port's ``ResidentStore`` must equal the reference's across claim churn,
the snapshot encode must equal a fresh one, and the torch grid must read
the resident rows.  ``bench.py::run_repack``'s fleet (2000 claims x 500
types) is the ``slow`` case.
"""

import numpy as np
import pytest

import bench
import karpenter_tpu.apis.nodeclaim as j_nodeclaim
import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.apis.podgroup as j_podgroup
import karpenter_tpu.core.cluster as j_cluster
from karpenter_tpu.repack import RepackOptions as JRepackOptions
from karpenter_tpu.repack import RepackPlanner as JRepackPlanner
from karpenter_tpu.repack import encode_repack as j_encode_repack
from karpenter_tpu.resident.store import (
    OccupancySnapshot as JOccupancySnapshot,
)
from karpenter_tpu.resident.store import ResidentStore as JResidentStore
from karpenter_tpu.solver.validate import (
    validate_repack_plan as j_validate_repack_plan,
)

import karpenter_tpu_torch.apis.nodeclaim as t_nodeclaim
import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.podgroup as t_podgroup
import karpenter_tpu_torch.core.cluster as t_cluster
from karpenter_tpu_torch import carry
from karpenter_tpu_torch.repack import (
    KIND_DEFRAG, ReopenedSlice, RepackOptions, RepackPlanner, encode_repack,
    parked_gang_shapes,
)
from karpenter_tpu_torch.repack import planner as t_planner
from karpenter_tpu_torch.resident.store import (
    OccupancySnapshot, ResidentStore,
)
from karpenter_tpu_torch.solver.validate import validate_repack_plan

ACCEL = "gx3-64x512"      # 8 gpu -> (2, 2, 2) torus
SMALL = "bx2-4x16"
BIG = "bx2-16x64"
PRICE = {SMALL: 0.2, BIG: 0.8, ACCEL: 3.0}


def carried(jcat):
    return carry.catalog_from_numpy(
        type_torus=jcat.type_torus,
        **{f: getattr(jcat, f) for f in carry.CATALOG_FIELDS})


@pytest.fixture(scope="module")
def catalogs():
    from karpenter_tpu.catalog import (
        CatalogArrays, InstanceTypeProvider, PricingProvider,
    )
    from karpenter_tpu.cloud.fake import FakeCloud, generate_profiles

    cloud = FakeCloud(profiles=generate_profiles(
        24, families=("gx3", "bx2", "cx2")))
    pricing = PricingProvider(cloud)
    try:
        jcat = CatalogArrays.build(InstanceTypeProvider(cloud, pricing).list())
    finally:
        pricing.close()
    return jcat, carried(jcat)


class Fleet:
    """Records of a fleet: claims (name, type, price, zone, initialized,
    tainted) and pods (name, node or "", cpu, mem, gpu, gang index or
    None, tolerates the taint), gangs (name, min_member, shape)."""

    def __init__(self):
        self.claims, self.pods, self.gangs = [], [], []

    def claim(self, name, itype=BIG, zone="us-south-1", initialized=True,
              tainted=False, price=None):
        self.claims.append((name, itype, PRICE[itype] if price is None
                            else price, zone, initialized, tainted))
        return f"node-{name}" if initialized else ""

    def pod(self, name, node, cpu=500, mem=1024, gpu=0, gang=None,
            tolerate=False):
        self.pods.append((name, node, cpu, mem, gpu, gang, tolerate))

    def build(self, pod_mod, nc_mod, cl_mod, pg_mod):
        cluster = cl_mod.ClusterState()
        taint = pod_mod.Taint("dedicated", "infra")
        for name, itype, price, zone, init, tainted in self.claims:
            cluster.add_nodeclaim(nc_mod.NodeClaim(
                name=name, instance_type=itype, zone=zone,
                node_name=f"node-{name}" if init else "",
                hourly_price=price, launched=True, initialized=init,
                taints=(taint,) if tainted else ()))
        gangs = [pg_mod.PodGroup(name=n, min_member=m, slice_shape=s,
                                 deadline_seconds=1e9)
                 for n, m, s in self.gangs]
        for name, node, cpu, mem, gpu, gang, tol in self.pods:
            cluster.add_pod(pod_mod.PodSpec(
                name, requests=pod_mod.ResourceRequests(cpu, mem, gpu, 1),
                gang=None if gang is None else gangs[gang],
                tolerations=(pod_mod.Toleration("dedicated", "Exists"),)
                if tol else ()))
            if node:
                cluster.bind_pod(f"default/{name}", node)
        return cluster

    def both(self):
        return (self.build(j_pod, j_nodeclaim, j_cluster, j_podgroup),
                self.build(t_pod, t_nodeclaim, t_cluster, t_podgroup))


def random_fleet(seed, n_lo=4, n_hi=12):
    """``tests/test_repack.py::_random_world``'s shape, with a tainted
    claim now and then and pods that tolerate it."""
    rng = np.random.RandomState(seed)
    f = Fleet()
    for i in range(int(rng.randint(n_lo, n_hi))):
        itype = [SMALL, BIG, ACCEL][int(rng.randint(3))]
        node = f.claim(f"w{i}", itype,
                       zone=f"us-south-{int(rng.randint(1, 3))}",
                       tainted=bool(rng.rand() < 0.15))
        for j in range(int(rng.randint(0, 4))):
            gpu = int(rng.randint(0, 3)) if itype == ACCEL else 0
            f.pod(f"w{i}p{j}", node, cpu=int(rng.randint(100, 1500)),
                  mem=int(rng.randint(256, 3000)), gpu=gpu,
                  tolerate=bool(rng.rand() < 0.3))
    if seed % 2:
        f.gangs.append((f"park{seed}", 4, "2x2x2"))
        for j in range(4):
            f.pod(f"gm{j}", "", gang=0)
    return f


def defrag_fleet():
    """Two accelerator nodes with gpu=2 singletons (3 and 1), and a parked
    2x2x2 gang that fits nowhere until one torus is vacated
    (``bench.py::_run_repack_defrag``)."""
    f = Fleet()
    pk = 0
    for i in range(2):
        node = f.claim(f"a{i}", ACCEL)
        for _ in range(3 if i == 0 else 1):
            f.pod(f"sg{pk}", node, gpu=2)
            pk += 1
    f.gangs.append(("parked-1", 4, "2x2x2"))
    for j in range(4):
        f.pod(f"pg{j}", "", gang=0)
    return f


def plan_view(plan):
    return ([(m.pod_key, m.src_claim, m.dst_claim, m.kind)
             for m in plan.migrations], list(plan.drained),
            [(r.claim_name, r.offering, tuple(r.shape), r.pre_mask,
              r.post_mask) for r in plan.reopened],
            plan.current_cost, plan.proposed_cost, plan.candidate_count)


ENCODE_FIELDS = ("node_off", "node_zone", "resid", "pod_count", "eligible",
                 "price_milli", "n_chips", "movable_all", "maxpod",
                 "sing_demand", "sing_max", "sing_count", "occ_mask",
                 "sing_mask", "sig_rows", "sig_zone_pinned", "taint_ok")


def assert_encoded_equal(jp, tp):
    assert tp.claim_names == jp.claim_names
    assert tp.parked_shapes == jp.parked_shapes
    for f in ENCODE_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    assert [[(r.key, r.sig, r.gpu, r.movable, r.single, r.chip_mask)
             for r in refs] for refs in tp.pods] == \
        [[(r.key, r.sig, r.gpu, r.movable, r.single, r.chip_mask)
          for r in refs] for refs in jp.pods]


def plans(fleet, catalogs, use):
    jcat, tcat = catalogs
    jcl, tcl = fleet.both()
    jprob = j_encode_repack(jcl, jcat)
    tprob = encode_repack(tcl, tcat)
    assert_encoded_equal(jprob, tprob)
    jplan = JRepackPlanner(JRepackOptions(use_device=use)).plan(jprob)
    planner = RepackPlanner(RepackOptions(use_device=use), device="cpu")
    tplan = planner.plan(tprob)
    return (jcl, jplan), (tcl, tplan), planner


@pytest.mark.parametrize("use", ["off", "on"])
@pytest.mark.parametrize("seed", range(8))
def test_plans_equal_reference_on_both_routes(catalogs, seed, use):
    (jcl, jplan), (tcl, tplan), planner = plans(random_fleet(seed),
                                                catalogs, use)
    assert plan_view(tplan) == plan_view(jplan)
    assert tplan.backend == jplan.backend == \
        ("device" if use == "on" else "vector")
    assert planner.device_steps == (1 if use == "on" else 0)
    assert validate_repack_plan(tplan, tcl, catalogs[1]) == []
    assert j_validate_repack_plan(jplan, jcl, catalogs[0]) == []


@pytest.mark.parametrize("use", ["off", "on"])
def test_defrag_reopens_slice_equal_to_reference(catalogs, use):
    (_, jplan), (tcl, tplan), _ = plans(defrag_fleet(), catalogs, use)
    assert plan_view(tplan) == plan_view(jplan)
    assert tplan.slices_reopened == 1
    assert tplan.reopened[0].claim_name == "a0"
    assert tplan.reopened[0].shape == (2, 2, 2)
    assert all(m.kind == KIND_DEFRAG for m in tplan.migrations)
    assert tplan.drained == []
    assert validate_repack_plan(tplan, tcl, catalogs[1]) == []


def test_auto_route_takes_torch_grid_from_size(catalogs):
    """70 claims: 4900 pairwise cells, past ``_DEVICE_MIN_CELLS``."""
    (_, jplan), (_, tplan), planner = plans(random_fleet(3, 70, 71),
                                            catalogs, "auto")
    assert 70 * 70 >= t_planner._DEVICE_MIN_CELLS
    assert planner.device_steps == 1 and tplan.backend == "device"
    assert plan_view(tplan) == plan_view(jplan)
    small = RepackPlanner(RepackOptions(use_device="auto"), device="cpu")
    small.plan(encode_repack(random_fleet(0).both()[1], catalogs[1]))
    assert small.device_steps == 0


def test_int32_guard_keeps_numpy_route(catalogs):
    """A price past int32 in milli-$ keeps even a forced-on plan on the
    numpy grid (the torch grid's int32 arithmetic would wrap)."""
    f = random_fleet(2)
    f.claims[0] = f.claims[0][:2] + (3e6,) + f.claims[0][3:]
    (_, jplan), (_, tplan), planner = plans(f, catalogs, "on")
    assert planner.device_steps == 0 and tplan.backend == "vector"
    assert plan_view(tplan) == plan_view(jplan)


def test_grid_failure_raises(catalogs, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("grid failed")

    monkeypatch.setattr(t_planner, "score_grid_torch", broken)
    prob = encode_repack(defrag_fleet().both()[1], catalogs[1])
    with pytest.raises(RuntimeError, match="grid failed"):
        RepackPlanner(RepackOptions(use_device="on"),
                      device="cpu").plan(prob)


def test_torch_grid_equals_numpy_grid_with_high_mask_bits(catalogs):
    """Chip masks with bit 31 and bit 63 set (negative int32 words) give
    the numpy grid's kinds and scores."""
    _, tcat = catalogs
    prob = encode_repack(random_fleet(5).both()[1], tcat)
    prob.occ_mask = prob.occ_mask | np.uint64(1 << 31) | np.uint64(1 << 63)
    planner = RepackPlanner(RepackOptions(use_device="on"), device="cpu")
    kind, score, reopened, _ = planner._grid_device(prob, prob.tables)
    want = planner._grid_numpy(prob, prob.tables)
    for got, ref in zip((kind, score, reopened), want):
        np.testing.assert_array_equal(got, ref)


def test_parked_gang_shapes_only_unnominated(catalogs):
    f = Fleet()
    f.gangs += [("p1", 1, "2x2"), ("p2", 1, "2x2x2")]
    f.pod("a", "", gang=0)
    f.pod("b", "", gang=1)
    jcl, tcl = f.both()
    for cl in (jcl, tcl):
        cl.get("pods", "default/b").nominated_node = "somewhere"
    assert parked_gang_shapes(tcl) == [(2, 2)]


def test_validator_flags_what_the_reference_flags(catalogs):
    jcat, tcat = catalogs
    (jcl, jplan), (tcl, tplan), _ = plans(defrag_fleet(), catalogs, "off")
    real = tplan.reopened[0]
    for plan in (jplan, tplan):
        plan.reopened[0] = type(plan.reopened[0])(
            claim_name=real.claim_name, offering=real.offering,
            shape=real.shape, pre_mask=real.pre_mask,
            post_mask=real.pre_mask)
        plan.migrations.pop()
    terr = validate_repack_plan(tplan, tcl, tcat)
    assert terr == j_validate_repack_plan(jplan, jcl, jcat)
    assert any("does NOT fit the vacated torus" in e for e in terr)
    assert isinstance(tplan.reopened[0], ReopenedSlice)


def churn_fleet(rounds=4):
    """Claim churn per round: one claim registered with a pod, one
    deleted (``tests/test_repack.py::TestOccupancyHandoff``)."""
    f = Fleet()
    for i in range(5):
        f.pod(f"hp{i}", f.claim(f"h{i}"))
    steps = []
    for r in range(rounds):
        steps.append((f"hx{r}", f"hpx{r}", 300 * (r + 1), f"h{r}"))
    return f, steps


def test_occupancy_rows_and_snapshot_equal_reference(catalogs):
    jcat, tcat = catalogs
    f, steps = churn_fleet()
    jcl, tcl = f.both()
    jstore, tstore = JResidentStore(), ResidentStore(device="cpu")
    modes = []
    for claim, pod, cpu, dead in steps:
        for cl, pod_mod, nc_mod in ((jcl, j_pod, j_nodeclaim),
                                    (tcl, t_pod, t_nodeclaim)):
            cl.add_nodeclaim(nc_mod.NodeClaim(
                name=claim, instance_type=BIG, zone="us-south-1",
                node_name=f"node-{claim}", hourly_price=0.8, launched=True,
                initialized=True))
            cl.add_pod(pod_mod.PodSpec(pod, requests=pod_mod.ResourceRequests(
                cpu, 1024, 0, 1)))
            cl.bind_pod(f"default/{pod}", f"node-{claim}")
            cl.list("nodeclaims", lambda c: c.name == dead)[0].deleted = True
        jnames, jdev, jdelta = jstore.occupancy_tensors(jcl, jcat)
        tnames, tdev, tdelta = tstore.occupancy_tensors(tcl, tcat)
        assert tnames == jnames
        assert (tdelta.mode, tdelta.words) == (jdelta.mode, jdelta.words)
        modes.append(tdelta.mode)
        np.testing.assert_array_equal(tstore.occupancy_rows(),
                                      jstore.occupancy_rows())
        np.testing.assert_array_equal(tdev.numpy(), np.asarray(jdev))
        jsnap, tsnap = JOccupancySnapshot(jcl), OccupancySnapshot(tcl)
        for name in [c.node_name for c in tcl.nodeclaims()] + ["", "x"]:
            assert tsnap.pods_on(name) == jsnap.pods_on(name)
        # the snapshot + store encode equals a fresh one, and so do the
        # plans on both routes; the torch grid reads the resident rows
        tprob = encode_repack(tcl, tcat, snapshot=tsnap, store=tstore)
        fresh = encode_repack(tcl, tcat)
        assert tprob.rows_host is not None
        assert tprob.rows_dev.data_ptr() == tdev.data_ptr()
        assert_encoded_equal(fresh, tprob)
        jplan = JRepackPlanner(JRepackOptions(use_device="off")).plan(
            j_encode_repack(jcl, jcat))
        for use in ("on", "off"):
            got = RepackPlanner(RepackOptions(use_device=use),
                                device="cpu").plan(tprob)
            assert plan_view(got) == plan_view(jplan)
    assert modes[0] == "rebuild" and "delta" in modes


def test_snapshot_lists_bound_and_nominated_in_collection_order(catalogs):
    f = Fleet()
    n0, n1 = f.claim("r0"), f.claim("r1")
    for i in range(4):
        f.pod(f"rp{i}", n0 if i % 2 == 0 else n1)
    jcl, tcl = f.both()
    for cl in (jcl, tcl):
        cl.get("pods", "default/rp3").nominated_node = "r0"
        cl.get("pods", "default/rp0").nominated_node = n0
    snaps = (JOccupancySnapshot(jcl), OccupancySnapshot(tcl))
    for name in (n0, n1, "r0", "r1", ""):
        assert snaps[1].pods_on(name) == snaps[0].pods_on(name)
    assert snaps[1].pods_on(n0) == ["default/rp0", "default/rp2"]
    assert snaps[1].pods_on("r0") == ["default/rp3"]


def bench_fleet(num_claims, catalog_types, pods_per_claim=2, seed=13):
    """``bench.py::run_repack``'s fleet: ``num_claims`` bx2-16x64 claims
    at 0.8 $/h, ``pods_per_claim`` pods each (100-1000m, 256-2048 Mi)."""
    rng = np.random.RandomState(seed)
    f = Fleet()
    pod_i = 0
    for i in range(num_claims):
        node = f.claim(f"rc{i}", BIG, price=0.8)
        for _ in range(pods_per_claim):
            f.pod(f"rp{pod_i}", node, cpu=int(rng.randint(100, 1000)),
                  mem=int(rng.randint(256, 2048)))
            pod_i += 1
    return f


def test_bench_fleet_small_equal_reference():
    jcat = bench.build_catalog(50)
    cats = (jcat, carried(jcat))
    (_, jplan), (tcl, tplan), planner = plans(bench_fleet(80, 50), cats,
                                              "auto")
    assert planner.device_steps == 1
    assert plan_view(tplan) == plan_view(jplan)
    assert tplan.migration_count > 0 and tplan.savings > 0
    assert validate_repack_plan(tplan, tcl, cats[1]) == []


@pytest.mark.slow
def test_bench_fleet_full_size_equal_reference():
    jcat = bench.build_catalog(500)
    cats = (jcat, carried(jcat))
    (_, jplan), (tcl, tplan), _ = plans(bench_fleet(2000, 500), cats, "on")
    assert plan_view(tplan) == plan_view(jplan)
    assert tplan.backend == "device"
    assert validate_repack_plan(tplan, tcl, cats[1]) == []
