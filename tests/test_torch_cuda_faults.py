"""Card tests of the port's fault and profiling planes (marker ``cuda``).

They skip without a CUDA device. On the card they run without the JAX
reference and without tests/conftest.py, as ``tests/test_torch_cuda.py``
does (whose fixture and scan inputs they repeat: ``tests`` is not a
package that card runs can import from):

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py tests/test_torch_cuda_faults.py -m cuda

A real allocator OOM and a launch error from the FFD library's C entry
inside ``device_guard`` are typed, and the card still computes after
each; probation runs the torch probe; a sampled probe times the device;
an injected OOM halves a batch; ``warmup_solver`` leaves the next window
of its shape no first dispatch; ``make_solver`` raises a faulted window
on the card (no window leaves it for the greedy oracle) and the
stochastic and affinity route strips re-run the window through
``ffd_scan`` (the degraded modes, small windows).
"""

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import TorchSolver, encode, validate_plan, workload
from karpenter_tpu_torch.solver import ffd_kernel
from karpenter_tpu_torch.solver.ffd_kernel import ffd_scan, ffd_scan_reference

BIG = 1 << 30


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, G=48, O=256):
    rng = np.random.RandomState(seed)
    meta = np.zeros((G, 8), np.int32)
    meta[:, 0] = rng.choice([0, 250, 1000, 4000], G)
    meta[:, 1] = rng.choice([0, 512, 8192], G)
    meta[:, 3] = 1
    meta[:, 4] = rng.randint(0, 80, G)
    meta[:, 5] = np.where(rng.rand(G) < 0.2, 1, BIG)
    compat = (rng.rand(G, O) < 0.7).astype(np.int32)
    alloc = np.zeros((O, 4), np.int32)
    alloc[:, 0] = rng.choice([2000, 16000, 64000], O)
    alloc[:, 1] = rng.choice([4096, 65536], O)
    alloc[:, 3] = rng.choice([30, 110], O)
    rank = (rng.rand(O) * 3 + 0.05).astype(np.float32)
    rank[1::5] = rank[0]
    return meta, compat, alloc, rank


class _ScriptedInjector:
    def __init__(self, script):
        self.script = list(script)
        self.injected = 0

    def draw(self, kernel, candidates):
        if not self.script:
            return None
        kind = self.script.pop(0)
        if kind is None:
            return None
        self.injected += 1
        return kind, candidates[0]

    def probe_faults(self, device):
        return False


@pytest.fixture
def fresh_board():
    from karpenter_tpu_torch import faulttol
    from karpenter_tpu_torch.faulttol import health as health_mod

    faulttol.clear_injector()
    health_mod._BOARD = None
    yield faulttol.get_health_board()
    faulttol.clear_injector()
    health_mod._BOARD = None


@pytest.mark.cuda
def test_allocator_oom_in_guard_is_resource_exhausted(cuda_device,
                                                      fresh_board):
    from karpenter_tpu_torch import faulttol

    ids = [faulttol.device_id(cuda_device)]
    with pytest.raises(faulttol.DeviceResourceExhausted) as info:
        with faulttol.device_guard("scan-batch", devices=ids):
            torch.empty(1 << 40, dtype=torch.uint8, device=cuda_device)
    assert isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)
    torch.cuda.empty_cache()
    snap = fresh_board.snapshot()["devices"][ids[0]]
    assert snap["last_kind"] == "oom" and snap["state"] == "suspect"
    # not sticky: the card still computes
    x = torch.arange(8, device=cuda_device) + 1
    assert int(x.sum()) == 36


@pytest.mark.cuda
def test_launch_error_from_the_c_entry_is_a_device_fault(cuda_device,
                                                         fresh_board):
    from karpenter_tpu_torch import cuda_build, faulttol

    lib = cuda_build.load("ffd_scan")
    nmax = lib.ffd_scan_max_nodes()
    meta, compat, alloc, rank = (torch.from_numpy(a).to(cuda_device)
                                 for a in _inputs(0, G=4, O=128))
    meta, compat = meta[None].contiguous(), compat[None].contiguous()
    rows = torch.zeros((1, 4, lib.ffd_scan_row_words(128)),
                       dtype=torch.int32, device=cuda_device)
    outs = [torch.zeros(n, dtype=torch.int32, device=cuda_device)
            for n in (nmax + 1, 4 * (nmax + 1), 4)]
    idx = cuda_device.index or 0
    err = lib.ffd_scan_launch(
        meta.data_ptr(), compat.data_ptr(), 0, alloc.data_ptr(), 0,
        rank.data_ptr(), 0, 0, rows.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr(), outs[2].data_ptr(), 1, 4, 128, nmax + 1,
        ffd_kernel.FIT_BIG, idx, cuda_build.stream_handle(idx))
    assert err == 1                          # cudaErrorInvalidValue
    ids = [faulttol.device_id(cuda_device)]
    with pytest.raises(faulttol.DeviceFaultError) as info:
        with faulttol.device_guard("scan", devices=ids):
            cuda_build.check_launch("ffd_scan", err,
                                    lib.ffd_scan_error_string)
    assert info.value.kind == "error"
    assert info.value.__cause__.code == 1
    # the wrapper refuses the same N on the host, unrecorded
    with pytest.raises(ValueError):
        with faulttol.device_guard("scan", devices=ids):
            ffd_scan(meta, compat, alloc, rank, nmax + 1)
    assert fresh_board.faults_recorded == 1
    # not sticky: the kernel still matches its plain version
    got = ffd_scan(meta, compat, alloc, rank, 64)
    want = ffd_scan_reference(meta, compat, alloc, rank, 64)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_probation_runs_the_torch_probe_on_the_card(cuda_device):
    from karpenter_tpu_torch import faulttol

    dev = faulttol.device_id(cuda_device)
    now = [1000.0]
    board = faulttol.HealthBoard(clock=lambda: now[0],
                                 triage_writer=lambda *a, **k: None)
    for _ in range(board.fault_threshold):
        board.record_fault(dev, kind="error", kernel="scan")
    assert board.state(dev) == "quarantined"
    walk = []
    for _ in range(board.probe_successes):
        now[0] += board.recovery_timeout_s + 1.0
        board.tick()
        walk.append(board.state(dev))
    assert walk == ["probation", "healthy"]


@pytest.mark.cuda
def test_sampled_probe_times_the_device_on_the_card(cuda_device):
    from karpenter_tpu_torch.obs.prof import DeviceProfiler

    meta, compat, alloc, rank = (torch.from_numpy(a).to(cuda_device)
                                 for a in _inputs(1, G=48, O=256))
    meta, compat = meta[None].contiguous(), compat[None].contiguous()
    ffd_scan(meta, compat, alloc, rank, 384)
    prof = DeviceProfiler(interval=1)
    with prof.sampled("scan") as probe:
        out = ffd_scan(meta, compat, alloc, rank, 384)
        probe.dispatched(out)
    assert prof.samples == 1
    assert probe.device_s > 0.0 and probe.fetch_s > 0.0
    assert prof.snapshot()["kernels"]["scan"]["device_ms"] > 0.0


@pytest.mark.cuda
def test_injected_oom_halves_a_batch_on_the_card(cuda_device, fresh_board):
    from karpenter_tpu_torch import faulttol

    pods, catalog = workload.build_workload(1600, 60, seed=5)
    problems = [encode(pods[i::8], catalog) for i in range(8)]
    solver = TorchSolver(device=cuda_device)
    whole = solver.solve_encoded_batch(problems)
    assert solver.last_stats["batch"] == 8
    inj = _ScriptedInjector(["oom"])
    faulttol.install_injector(inj)
    halved = solver.solve_encoded_batch(problems)
    faulttol.clear_injector()
    assert inj.injected == 1 and solver.last_stats["batch"] == 4
    for a, b in zip(halved, whole):
        assert [(n.offering_index, n.pod_names) for n in a.nodes] == \
            [(n.offering_index, n.pod_names) for n in b.nodes]
        assert a.total_cost_per_hour == b.total_cost_per_hour


@pytest.mark.cuda
def test_warmup_solver_on_the_card(cuda_device):
    from karpenter_tpu_torch.obs.devtel import get_devtel
    from karpenter_tpu_torch.solver.warmup import warmup_solver

    pods, catalog = workload.build_workload(600, 40, seed=9)
    problem = encode(pods, catalog)
    solver = TorchSolver(device=cuda_device)
    prep = solver._prepare(problem)
    n = warmup_solver(solver, catalog, shapes=[
        (prep.G_pad, prep.U_pad, prep.N, int(problem.group_count.sum()))],
        batch_widths=(2,))
    assert n == 2
    rec = get_devtel().recompiles
    plan = solver.solve_encoded(problem)
    assert get_devtel().recompiles == rec
    assert validate_plan(plan, pods, catalog) == []


def _view(plan):
    return ([(n.offering_index, n.pod_names) for n in plan.nodes],
            plan.unplaced_pods)


@pytest.mark.cuda
def test_make_solver_raises_a_faulted_window_on_the_card(cuda_device,
                                                         fresh_board):
    """(u1) at a small size: ``make_solver`` gives ``TorchSolver``'s plan;
    a scripted error on the next dispatch raises ``DeviceFaultError`` out
    of it with no breadcrumb, the resident store invalidated once; the
    next window runs ``ffd_scan`` on the card again."""
    from karpenter_tpu_torch import SolveRequest, SolverOptions, faulttol
    from karpenter_tpu_torch import make_solver
    from karpenter_tpu_torch.solver.degraded import breadcrumbs

    pods, catalog = workload.build_workload(600, 40, seed=12)
    request = SolveRequest(pods, catalog)
    want = TorchSolver(device=cuda_device).solve(request)
    solver = make_solver(SolverOptions(resident="on"), device=cuda_device)
    plan = solver.solve(request)
    assert _view(plan) == _view(want) and plan.backend == "torch"
    before = breadcrumbs()
    faulttol.install_injector(_ScriptedInjector(["error"]))
    try:
        with pytest.raises(faulttol.DeviceFaultError):
            solver.solve(request)
    finally:
        faulttol.clear_injector()
    assert solver.resident.invalidations == 1
    assert breadcrumbs() == before
    fresh_board.reset()
    n0 = ffd_kernel.LAUNCHES["ffd_scan"]
    plan = solver.solve(request)
    assert ffd_kernel.LAUNCHES["ffd_scan"] > n0
    assert _view(plan) == _view(want) and plan.backend == "torch"


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["stochastic", "affinity"])
def test_route_strip_reruns_the_ffd_kernel_on_the_card(cuda_device,
                                                       monkeypatch, route):
    """(u2) at a small size: the route's program raises a host-side
    error; the window re-runs through ``ffd_scan`` on the card with one
    breadcrumb, its plan the CPU's stripped plan; the same window again
    takes the scan with none."""
    from karpenter_tpu_torch import SolveRequest
    from karpenter_tpu_torch.apis.nodeclaim import NodePool
    import importlib

    from karpenter_tpu_torch.solver import torch_backend
    from karpenter_tpu_torch.solver.degraded import breadcrumbs

    encode_mod = importlib.import_module("karpenter_tpu_torch.solver.encode")
    catalog = workload.build_catalog(40)
    if route == "stochastic":
        request = SolveRequest(workload.stochastic_pods(600, seed=13),
                               catalog, NodePool(name="default",
                                                 overcommit=0.05))
        program = "solve_packed_stochastic"
    else:
        request = SolveRequest(workload.affinity_bench_pods(
            "aff", 600, np.random.RandomState(19)), catalog)
        program = "solve_packed_affinity"

    def broken(*a, **k):
        raise RuntimeError(f"scripted {route} program fault")

    monkeypatch.setattr(torch_backend, program, broken)
    encode_mod._ENCODE_MEMO.clear()
    problem = encode_mod.encode(request.pods, catalog, request.nodepool)
    before = breadcrumbs()
    n0 = ffd_kernel.LAUNCHES["ffd_scan"]
    solver = TorchSolver(device=cuda_device)
    plan = solver.solve_encoded(problem)
    assert ffd_kernel.LAUNCHES["ffd_scan"] == n0 + 1
    key = f"errors{{solver,{route}_fallback}}"
    assert breadcrumbs()[key] == before.get(key, 0.0) + 1
    want = TorchSolver(device="cpu").solve_encoded(problem)
    assert _view(plan) == _view(want)
    mid = breadcrumbs()
    again = solver.solve_encoded(problem)
    assert ffd_kernel.LAUNCHES["ffd_scan"] == n0 + 2
    assert breadcrumbs() == mid and _view(again) == _view(want)
    encode_mod._ENCODE_MEMO.clear()
