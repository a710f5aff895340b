"""The port's gRPC solver sidecar against the reference's.

Both packages' servers listen on 127.0.0.1 (port 0) in this process; the
port's serves ``TorchSolver(device="cpu")``.  The same windows (the
headline shape cut small, a flat window, preference windows with the
penalty weight on the wire, a zone-candidate batch through
``SolveBatch``, a catalog re-upload after a generation bump and an
unknown catalog) go through every pairing of client and server, and the
plans, the reply arrays and the errors must be equal to each other and
to ``TorchSolver(device="cpu")`` called directly.  The solver hooks the
sidecar calls (``prepare_arrays`` with the shared fetch loop,
``compute_handle``, ``flat_compute_handle``) are held against the
reference's and against a normal solve, and ``make_solver(backend=
"remote")`` degrades behind a sidecar on the CPU and raises behind one
that names a CUDA device.
"""

from __future__ import annotations

import sys

import grpc
import numpy as np
import pytest
import torch

import bench
import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.service as j_service
from karpenter_tpu.core.provisioner import make_solver as j_make_solver
from karpenter_tpu.solver import JaxSolver
from karpenter_tpu.solver import SolveRequest as JSolveRequest
from karpenter_tpu.solver import SolverOptions as JSolverOptions
from karpenter_tpu.solver import encode as j_encode
from karpenter_tpu.solver.jax_backend import _pad1 as j_pad1
from karpenter_tpu.solver.jax_backend import _pad2 as j_pad2
from karpenter_tpu.utils import metrics as j_metrics

import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.service as t_service
from karpenter_tpu_torch import carry, workload
from karpenter_tpu_torch.core.provisioner import make_solver
from karpenter_tpu_torch.solver import SolveRequest, SolverOptions, TorchSolver
from karpenter_tpu_torch.solver import encode as t_encode
from karpenter_tpu_torch.solver.flat import (
    dispatch_flat, flat_compute_handle,
)
from karpenter_tpu_torch.solver.types import (
    GROUP_BUCKETS, OFFERING_BUCKETS, bucket,
)
from karpenter_tpu_torch.utils import metrics as t_metrics

from tests.test_torch_solver import assert_plans_equal, node_view

FLAT_MIN = 64                      # the flat route at a CPU-sized window


def serve(mod, flat=False, **kw):
    if mod is t_service:
        kw.setdefault("device", "cpu")
        opts = SolverOptions(flat_min_groups=FLAT_MIN) if flat else None
    else:
        opts = JSolverOptions(backend="jax", flat_min_groups=FLAT_MIN) \
            if flat else None
    return mod.SolverServer(port=0, options=opts, **kw).start()


@pytest.fixture(scope="module")
def servers():
    """{(package, flat): server}: both packages, default and low flat
    threshold."""
    out = {(k, flat): serve(mod, flat)
           for k, mod in (("t", t_service), ("j", j_service))
           for flat in (False, True)}
    yield out
    for s in out.values():
        s.stop()


def client(mod, server, **opts):
    cls = SolverOptions if mod is t_service else JSolverOptions
    kw = {} if mod is t_service else {"backend": "remote"}
    return mod.RemoteSolver(f"127.0.0.1:{server.port}",
                            cls(**kw, **opts) if opts else None)


PAIRS = [("t", "t"), ("j", "t"), ("t", "j"), ("j", "j")]   # client, server
MODS = {"t": t_service, "j": j_service}


def windows(kind):
    """(reference pods, reference catalog, port pods, port catalog, flat)
    of one window kind."""
    if kind == "headline":
        jp, jc = bench.build_workload(1500, 40, seed=42)
        tp, tc = workload.build_workload(1500, 40, seed=42)
        return jp, jc, tp, tc, False
    if kind == "flat":
        jp, jc = bench.build_hetero_workload(300, 12, seed=7)
        tp, tc = workload.build_hetero_workload(300, 12, seed=7)
        return jp, jc, tp, tc, True
    if kind == "flat-pref":
        jp, jc = bench.build_hetero_workload(300, 12, seed=4, pref_frac=0.3)
        tp, tc = workload.build_hetero_workload(300, 12, seed=4,
                                                pref_frac=0.3)
        return jp, jc, tp, tc, True
    assert kind == "pref"
    jp, jc = bench.build_hetero_workload(40, 12, seed=5, pref_frac=0.5)
    tp, tc = workload.build_hetero_workload(40, 12, seed=5, pref_frac=0.5)
    return jp, jc, tp, tc, False


def local_plan(tpods, tcat, flat, **opts):
    if flat:
        opts["flat_min_groups"] = FLAT_MIN
    ts = TorchSolver(SolverOptions(**opts), device="cpu")
    plan = ts.solve(SolveRequest(tpods, tcat))
    return plan, ts.last_stats["path"]


@pytest.mark.parametrize("kind", ["headline", "flat", "flat-pref", "pref"])
def test_every_pairing_plans_as_the_local_solver(servers, kind):
    jpods, jcat, tpods, tcat, flat = windows(kind)
    local, path = local_plan(tpods, tcat, flat)
    assert path == {"headline": "ffd-reference", "flat": "flat-cpu",
                    "flat-pref": "flat-cpu", "pref": "pref-cpu"}[kind]
    for ck, sk in PAIRS:
        c = client(MODS[ck], servers[(sk, flat)])
        try:
            pods, cat = (tpods, tcat) if ck == "t" else (jpods, jcat)
            req = (SolveRequest if ck == "t" else JSolveRequest)(pods, cat)
            plan = c.solve(req)
        finally:
            c.close()
        assert plan.backend == "remote"
        assert node_view(plan) == node_view(local), (ck, sk)
        assert plan.unplaced_pods == local.unplaced_pods
        assert plan.total_cost_per_hour == pytest.approx(
            local.total_cost_per_hour, rel=1e-6)


def wire_request(problem, cat_id, gen, lam=None, coo_ok=True):
    """The Solve request bytes a client sends for ``problem``."""
    G = bucket(problem.num_groups, GROUP_BUCKETS)
    O = bucket(problem.catalog.num_offerings, OFFERING_BUCKETS)
    kw = {}
    if problem.label_rows is not None:
        lidx = np.zeros(G, np.int32)
        lidx[:problem.label_idx.shape[0]] = problem.label_idx
        kw.update(label_rows=j_pad2(problem.label_rows,
                                    problem.label_rows.shape[0], O),
                  label_idx=lidx)
    if problem.pref_rows is not None:
        pidx = np.full(G, -1, np.int32)
        pidx[:problem.pref_idx.shape[0]] = problem.pref_idx
        kw.update(pref_rows=j_pad2(problem.pref_rows.astype(np.float32),
                                   problem.pref_rows.shape[0], O),
                  pref_idx=pidx,
                  pref_lambda_bp=np.int64(int((lam or 0.15) * 10000)))
    if coo_ok:
        kw["coo_ok"] = np.bool_(True)
    return t_service._pack(
        catalog_id=np.array(cat_id), generation=np.int64(gen),
        group_req=j_pad2(problem.group_req, G),
        group_count=j_pad1(problem.group_count, G),
        group_cap=j_pad1(problem.group_cap, G),
        compat=j_pad2(problem.compat, G, O), num_nodes=np.int64(128),
        n_cap=np.int64(4096), right_size=np.bool_(True), **kw)


def upload_request(cat, cat_id, gen):
    O = bucket(cat.num_offerings, OFFERING_BUCKETS)
    return t_service._pack(
        catalog_id=np.array(cat_id), generation=np.int64(gen),
        off_alloc=j_pad2(cat.offering_alloc().astype(np.int32), O),
        off_price=j_pad1(cat.off_price.astype(np.float32), O),
        off_rank=j_pad1(cat.offering_rank_price(), O))


@pytest.mark.parametrize("kind,lam,coo_ok", [
    ("headline", None, True), ("flat", None, True), ("flat", None, False),
    ("flat-pref", 0.4, True), ("pref", 0.4, True)])
def test_handlers_reply_the_reference_words(kind, lam, coo_ok):
    """One request's bytes through both packages' handlers, in process
    (no transport): every reply array is equal, the cost word too."""
    _, _, tpods, tcat, flat = windows(kind)
    problem = t_encode(tpods, tcat)
    t_opts = SolverOptions(flat_min_groups=FLAT_MIN) if flat else None
    j_opts = JSolverOptions(backend="jax", flat_min_groups=FLAT_MIN) \
        if flat else None
    th = t_service.SolverHandlers(t_opts, device="cpu")
    js = j_service.SolverServer(port=0, options=j_opts)
    try:
        up = upload_request(tcat, "cat-a", 3)
        assert js._upload(up, None) == th._upload(up) == b"ok"
        req = wire_request(problem, "cat-a", 3, lam=lam, coo_ok=coo_ok)
        jr = t_service._unpack(js._solve(req, None))
        tr = t_service._unpack(th._solve(req))
    finally:
        js.stop()
    assert sorted(tr) == sorted(jr)
    assert ("assign_coo_idx" in tr) == (flat and coo_ok)
    for k in jr:
        assert tr[k].dtype == jr[k].dtype, k
        np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)


def test_unknown_catalog_is_the_same_error_everywhere(servers):
    _, _, tpods, tcat, _ = windows("pref")
    req = wire_request(t_encode(tpods, tcat), "never-uploaded", 1)
    th = t_service.SolverHandlers(device="cpu")
    jr = t_service._unpack(servers[("j", False)]._solve(req, None))
    tr = t_service._unpack(th._solve(req))
    assert str(tr["error"]) == str(jr["error"]) == \
        "unknown catalog; re-upload"
    # a client whose memo says "uploaded" but whose re-upload is broken
    # surfaces the error once, against either server
    for ck, sk in PAIRS:
        mod = MODS[ck]
        c = client(mod, servers[(sk, False)])
        pods = t_pod.make_pods(3, requests=t_pod.ResourceRequests(
            500, 1024, 0, 1)) if ck == "t" else j_pod.make_pods(
            3, requests=j_pod.ResourceRequests(500, 1024, 0, 1))
        cat = tcat if ck == "t" else bench.build_catalog(12)
        c._uploaded[f"{cat.uid}"] = mod.RemoteSolver._catalog_key(cat)[1]
        c._ensure_catalog = lambda *a, **k: None
        try:
            with pytest.raises(RuntimeError, match="unknown catalog"):
                c.solve_encoded((t_encode if ck == "t" else j_encode)(
                    pods, cat))
        finally:
            c.close()


@pytest.mark.parametrize("sk", ["t", "j"])
def test_catalog_reupload_after_a_generation_bump(servers, sk):
    """A bumped catalog generation re-uploads once; a sidecar that lost
    its catalogs (a stale memo) is re-uploaded and the solve retried."""
    _, _, tpods, _, _ = windows("headline")
    tcat = workload.build_catalog(40)
    c = client(t_service, servers[(sk, False)])
    try:
        first = c.solve(SolveRequest(tpods, tcat))
        key = dict(c._uploaded)
        tcat.generation += 1
        bumped = c.solve(SolveRequest(tpods, tcat))
        assert c._uploaded != key
        assert node_view(bumped) == node_view(first)
        c._uploaded.clear()
        c._uploaded[f"{tcat.uid}"] = 12345     # the server never saw it
        again = c.solve(SolveRequest(tpods, tcat))
        assert node_view(again) == node_view(first)
    finally:
        c.close()
    assert c.device == (torch.device("cpu") if sk == "t" else None)


def zone_window():
    """The reference's skewed zone catalog (zone 2 is cheaper than the
    capacity pin) with six zone-affinity pods, in both packages."""
    from tests.test_zonesplit import _skewed_catalog

    jcat = _skewed_catalog()
    tcat = carry.catalog_from_numpy(
        **{f: getattr(jcat, f) for f in carry.CATALOG_FIELDS})

    def pods(pm):
        term = pm.PodAffinityTerm(label_selector=(("app", "web"),),
                                  topology_key="topology.kubernetes.io/zone",
                                  anti=False)
        return [pm.PodSpec(f"w{i}", requests=pm.ResourceRequests(
            500, 1024, 0, 1), labels=(("app", "web"),), affinity=(term,))
            for i in range(6)]

    return pods(j_pod), jcat, pods(t_pod), tcat


@pytest.mark.parametrize("ck,sk", PAIRS)
def test_zone_candidates_ride_one_solve_batch(servers, ck, sk):
    """The zone refinement through the remote backend takes one
    ``SolveBatch`` call a round, and the candidates' plans equal the
    local solver's batch."""
    from karpenter_tpu_torch.solver.zonesplit import (
        _with_zone, affinity_candidates,
    )

    jpods, jcat, tpods, tcat = zone_window()
    local = TorchSolver(device="cpu").solve(SolveRequest(tpods, tcat))
    assert {n.zone for n in local.nodes} == {"us-south-2"}
    prob = t_encode(tpods, tcat)
    gi, _, zones = affinity_candidates(prob)[0]
    local_b = TorchSolver(device="cpu").solve_encoded_batch(
        [_with_zone(prob, gi, z) for z in zones])
    mod = MODS[ck]
    c = client(mod, servers[(sk, False)])
    calls = {"batch": 0}
    orig = c.solve_encoded_batch

    def count(probs):
        calls["batch"] += 1
        return orig(probs)

    c.solve_encoded_batch = count
    try:
        if ck == "t":
            plan = c.solve(SolveRequest(tpods, tcat))
            batched = orig([_with_zone(prob, gi, z) for z in zones])
        else:
            from karpenter_tpu.solver.zonesplit import _with_zone as jwz

            plan = c.solve(JSolveRequest(jpods, jcat))
            jprob = j_encode(jpods, jcat)
            batched = orig([jwz(jprob, gi, z) for z in zones])
    finally:
        c.close()
    assert calls["batch"] == 1
    assert node_view(plan) == node_view(local)
    assert [node_view(b) for b in batched] == [node_view(b) for b in local_b]
    assert [b.unplaced_pods for b in batched] == \
        [b.unplaced_pods for b in local_b]


def test_batch_handler_pads_with_row_zero_and_replies_the_reference_words():
    from karpenter_tpu_torch.solver.zonesplit import (
        _with_zone, affinity_candidates,
    )

    _, _, tpods, tcat = zone_window()
    prob = t_encode(tpods, tcat)
    gi, _, zones = affinity_candidates(prob)[0]
    probs = [_with_zone(prob, gi, z) for z in zones] * 2 + [prob]
    G = bucket(prob.num_groups, GROUP_BUCKETS)
    O = bucket(tcat.num_offerings, OFFERING_BUCKETS)
    req = t_service._pack(
        catalog_id=np.array("z"), generation=np.int64(1),
        group_req=j_pad2(prob.group_req, G),
        group_count=j_pad1(prob.group_count, G),
        group_cap=j_pad1(prob.group_cap, G),
        compat=np.stack([j_pad2(p.compat, G, O) for p in probs]),
        num_nodes=np.int64(64), n_cap=np.int64(4096),
        right_size=np.bool_(True))
    th = t_service.SolverHandlers(device="cpu")
    js = j_service.SolverServer(port=0)
    try:
        up = upload_request(tcat, "z", 1)
        th._upload(up)
        js._upload(up, None)
        tr = t_service._unpack(th._solve_batch(req))
        jr = t_service._unpack(js._solve_batch(req, None))
    finally:
        js.stop()
    assert tr["node_off"].shape[0] == len(probs)      # C, not C_pad
    assert sorted(tr) == sorted(jr)
    for k in jr:
        np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)


def test_prepare_arrays_and_the_shared_loop_equal_the_reference():
    """``prepare_arrays`` + ``_solve_prepared`` on padded wire arrays,
    with node escalation from a small node axis, against the
    reference's."""
    _, _, tpods, tcat, _ = windows("headline")
    problem = t_encode(tpods, tcat)
    G = bucket(problem.num_groups, GROUP_BUCKETS)
    O = bucket(tcat.num_offerings, OFFERING_BUCKETS)
    arrays = dict(group_req=j_pad2(problem.group_req, G),
                  group_count=j_pad1(problem.group_count, G),
                  group_cap=j_pad1(problem.group_cap, G),
                  compat=j_pad2(problem.compat, G, O))
    cats = {}
    for k, mod in (("t", t_service), ("j", j_service)):
        cats[k] = mod._UploadedCatalog(
            "u", 1, j_pad2(tcat.offering_alloc().astype(np.int32), O),
            j_pad1(tcat.off_price.astype(np.float32), O),
            j_pad1(tcat.offering_rank_price(), O))
    ts = TorchSolver(device="cpu")
    js = JaxSolver(JSolverOptions(use_pallas="off"))
    out = {}
    for k, solver in (("t", ts), ("j", js)):
        prep = solver.prepare_arrays(cats[k], num_nodes=8, n_cap=4096,
                                     right_size=True, **arrays)
        out[k] = solver._solve_prepared(prep)
        assert prep.N > 8                        # escalated in the loop
    for a, b in zip(out["t"], out["j"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert ts.last_stats["escalations"] >= 1


def test_compute_handle_returns_the_words_of_a_normal_solve():
    _, _, tpods, tcat, _ = windows("headline")
    problem = t_encode(tpods, tcat)
    ts = TorchSolver(device="cpu")
    words = ts.dispatch_packed(ts._prepare(problem)).numpy()
    run = ts.compute_handle(problem)
    np.testing.assert_array_equal(run(3).numpy(), words)
    jpods, _ = bench.build_workload(1500, 40, seed=42)
    jrun = JaxSolver(JSolverOptions(use_pallas="off")).compute_handle(
        j_encode(jpods, bench.build_catalog(40)))
    np.testing.assert_array_equal(np.asarray(jrun(1)), words)


def test_flat_compute_handle_returns_the_words_of_a_flat_solve():
    _, _, tpods, tcat, _ = windows("flat")
    problem = t_encode(tpods, tcat)
    ts = TorchSolver(SolverOptions(flat_min_groups=FLAT_MIN), device="cpu")
    a = dispatch_flat(ts, problem)
    words = a.host.numpy()
    run = flat_compute_handle(ts, problem)
    np.testing.assert_array_equal(run(2).numpy(), words)
    assert flat_compute_handle(TorchSolver(device="cpu"), problem) is None


def errors_moved(metrics, before):
    return {k: v - before.get(k, 0.0)
            for k, v in metrics.ERRORS.samples().items()
            if v != before.get(k, 0.0)}


def failing(server, pkg):
    """Make every packed solve of ``server`` raise."""
    def boom(*a, **k):
        raise RuntimeError("sidecar solve failed")

    if pkg == "t":
        server.solver._solve_prepared = boom
    else:
        server._jax._solve_prepared = boom


def test_remote_backend_degrades_behind_a_cpu_sidecar():
    """A failing sidecar on the CPU: ``make_solver(backend="remote")``
    degrades the window to the greedy oracle, with the reference's
    ``ERRORS`` sample and plan."""
    jpods, jcat, tpods, tcat, _ = windows("headline")
    plans, moved = {}, {}
    for k, mod, mk, opts in (
            ("t", t_service, make_solver, SolverOptions),
            ("j", j_service, j_make_solver, JSolverOptions)):
        server = serve(mod)
        failing(server, k)
        metrics = t_metrics if k == "t" else j_metrics
        before = metrics.ERRORS.samples()
        solver = mk(opts(backend="remote",
                         address=f"127.0.0.1:{server.port}"))
        try:
            req = (SolveRequest(tpods, tcat) if k == "t"
                   else JSolveRequest(jpods, jcat))
            plans[k] = solver.solve(req)
        finally:
            solver.close()
            server.stop()
        moved[k] = errors_moved(metrics, before)
    assert moved["t"] == moved["j"] == \
        {("solver", "degraded_backend_failure"): 1.0}
    # the host oracle's tag names its loop (python, or the C++ twin
    # where that package's native library loaded)
    for plan in plans.values():
        assert plan.backend.startswith("degraded:greedy")
    assert_plans_equal(plans["j"], plans["t"])


def test_remote_backend_raises_behind_a_card_sidecar():
    """The same failure behind a sidecar whose replies name a CUDA device
    (faked: this box has no card) raises to the caller, with no
    breadcrumb."""
    _, _, tpods, tcat, _ = windows("pref")
    server = serve(t_service)
    server.device = torch.device("cuda", 0)      # what the replies name
    failing(server, "t")
    before = t_metrics.ERRORS.samples()
    solver = make_solver(SolverOptions(
        backend="remote", address=f"127.0.0.1:{server.port}"))
    try:
        with pytest.raises(grpc.RpcError):
            solver.solve(SolveRequest(tpods, tcat))
        assert solver.primary.device == torch.device("cuda", 0)
    finally:
        solver.close()
        server.stop()
    assert errors_moved(t_metrics, before) == {}


def test_a_failed_upload_raises_to_the_client():
    server = serve(t_service)

    def broken(*a, **k):
        raise RuntimeError("device upload failed")

    server.solver.device_offerings = broken
    _, _, tpods, tcat, _ = windows("pref")
    c = client(t_service, server)
    try:
        with pytest.raises(grpc.RpcError, match="device upload failed"):
            c.solve(SolveRequest(tpods, tcat))
        # the error status names the server's device
        assert c._uploaded == {} and c.device == torch.device("cpu")
    finally:
        c.close()
        server.stop()


def test_a_first_upload_failure_behind_a_card_sidecar_raises():
    """The sidecar's very first reply is an error status (its catalog
    upload failed on the device): it names the server's CUDA device, so
    ``make_solver(backend="remote")`` raises instead of degrading."""
    _, _, tpods, tcat, _ = windows("pref")
    server = serve(t_service)
    server.device = torch.device("cuda", 0)      # faked: no card here

    def broken(*a, **k):
        raise RuntimeError("device upload failed")

    server.solver.device_offerings = broken
    before = t_metrics.ERRORS.samples()
    solver = make_solver(SolverOptions(
        backend="remote", address=f"127.0.0.1:{server.port}"))
    try:
        with pytest.raises(grpc.RpcError, match="device upload failed"):
            solver.solve(SolveRequest(tpods, tcat))
        assert solver.primary.device == torch.device("cuda", 0)
    finally:
        solver.close()
        server.stop()
    assert errors_moved(t_metrics, before) == {}


def test_sidecar_samples_equal_the_reference(servers):
    """``SOLVE_DURATION{sidecar, sidecar-batch, remote}`` move alike."""
    jpods, jcat, tpods, tcat = zone_window()
    counts = {}
    for k, mod, metrics in (("t", t_service, t_metrics),
                            ("j", j_service, j_metrics)):
        before = {lab: metrics.SOLVE_DURATION.count(lab)
                  for lab in ("sidecar", "sidecar-batch", "remote")}
        c = client(mod, servers[(k, False)])
        try:
            c.solve((SolveRequest if k == "t" else JSolveRequest)(
                *((tpods, tcat) if k == "t" else (jpods, jcat))))
        finally:
            c.close()
        counts[k] = {lab: metrics.SOLVE_DURATION.count(lab) - n
                     for lab, n in before.items()}
    assert counts["t"] == counts["j"]
    assert counts["t"] == {"sidecar": 1, "sidecar-batch": 1, "remote": 1}


def test_handlers_need_no_grpc(monkeypatch):
    """The byte handlers build without gRPC; the transport needs it."""
    monkeypatch.setitem(sys.modules, "grpc", None)
    th = t_service.SolverHandlers(device="cpu")
    assert th.device == torch.device("cpu")
    with pytest.raises(ImportError):
        t_service.SolverServer(port=0, device="cpu")
    with pytest.raises(ImportError):
        t_service.RemoteSolver("127.0.0.1:1")


def test_main_parses_the_device_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        t_service.main(["--port", "0"])
