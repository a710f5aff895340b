"""The port imports neither JAX nor the reference package.

Checked in a fresh interpreter, because tests/conftest.py imports jax
into this one: every module of ``karpenter_tpu_torch`` and everything
``chip_smoke.py`` imports must leave ``jax`` and the module
``karpenter_tpu`` (and anything under ``karpenter_tpu.``) out of
``sys.modules``.  ``karpenter_tpu_torch`` itself starts with the string
``karpenter_tpu``, so the check tests the module name and the
``karpenter_tpu.`` prefix, never a bare ``startswith``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import karpenter_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(karpenter_tpu_torch.__path__,
                                              "karpenter_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "karpenter_tpu"
             or m.startswith("karpenter_tpu."))
print(json.dumps({"modules": mods, "bad": bad,
                  "torch": "torch" in sys.modules}))
"""


def _probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    res = _probe()
    assert res["bad"] == []
    assert res["torch"]
    # the walk really covered the package (kernel wrappers, build, carry,
    # the resident store, the serving loop, the what-if, gang and
    # preemption planes, the sharded service, the repack plane, the
    # fault and profiling planes, the oracles, the degraded modes, the
    # catalog intake, the provisioning loop, the controllers, the
    # sidecar, the chaos harness, the what-if service and the IKS,
    # load-balancer and HTTP cloud layer)
    for m in ("karpenter_tpu_torch.solver.ffd_kernel",
              "karpenter_tpu_torch.solver.packed",
              "karpenter_tpu_torch.cuda_build", "karpenter_tpu_torch.carry",
              "karpenter_tpu_torch.workload",
              "karpenter_tpu_torch.solver.presence_sum",
              "karpenter_tpu_torch.resident.delta",
              "karpenter_tpu_torch.resident.kernels",
              "karpenter_tpu_torch.resident.store",
              "karpenter_tpu_torch.serving.ring",
              "karpenter_tpu_torch.serving.oracle",
              "karpenter_tpu_torch.serving.kernels",
              "karpenter_tpu_torch.serving.service",
              "karpenter_tpu_torch.serving.validate",
              "karpenter_tpu_torch.solver.cost_sum",
              "karpenter_tpu_torch.core.cluster",
              "karpenter_tpu_torch.whatif.scenario",
              "karpenter_tpu_torch.whatif.kernels",
              "karpenter_tpu_torch.whatif.oracle",
              "karpenter_tpu_torch.whatif.planner",
              "karpenter_tpu_torch.whatif.validate",
              "karpenter_tpu_torch.gang.types",
              "karpenter_tpu_torch.gang.topology",
              "karpenter_tpu_torch.gang.encode",
              "karpenter_tpu_torch.gang.planner",
              "karpenter_tpu_torch.preempt.types",
              "karpenter_tpu_torch.preempt.encode",
              "karpenter_tpu_torch.preempt.planner",
              "karpenter_tpu_torch.sharded.types",
              "karpenter_tpu_torch.sharded.router",
              "karpenter_tpu_torch.sharded.encode",
              "karpenter_tpu_torch.sharded.kernels",
              "karpenter_tpu_torch.sharded.service",
              "karpenter_tpu_torch.sharded.solver",
              "karpenter_tpu_torch.sharded.validate",
              "karpenter_tpu_torch.repack.types",
              "karpenter_tpu_torch.repack.encode",
              "karpenter_tpu_torch.repack.planner",
              # the fault and profiling planes
              "karpenter_tpu_torch.utils.logging",
              "karpenter_tpu_torch.utils.metrics",
              "karpenter_tpu_torch.faulttol.errors",
              "karpenter_tpu_torch.faulttol.deadline",
              "karpenter_tpu_torch.faulttol.inject",
              "karpenter_tpu_torch.faulttol.health",
              "karpenter_tpu_torch.faulttol.dispatch",
              "karpenter_tpu_torch.obs.trace",
              "karpenter_tpu_torch.obs.ledger",
              "karpenter_tpu_torch.obs.export",
              "karpenter_tpu_torch.obs.devtel",
              "karpenter_tpu_torch.obs.prof",
              "karpenter_tpu_torch.obs.watchdog",
              "karpenter_tpu_torch.solver.warmup",
              "karpenter_tpu_torch.resident.aot",
              # the host greedy oracles and the per-pod C++ twin
              "karpenter_tpu_torch.native",
              "karpenter_tpu_torch.solver.greedy",
              "karpenter_tpu_torch.stochastic.greedy",
              "karpenter_tpu_torch.affinity.greedy",
              "karpenter_tpu_torch.explain.validate",
              "karpenter_tpu_torch.gang.greedy",
              "karpenter_tpu_torch.preempt.greedy",
              "karpenter_tpu_torch.repack.greedy",
              # the degraded modes
              "karpenter_tpu_torch.solver.degraded",
              "karpenter_tpu_torch.stochastic.degraded",
              "karpenter_tpu_torch.affinity.degraded",
              "karpenter_tpu_torch.sharded.degraded",
              "karpenter_tpu_torch.gang.degraded",
              "karpenter_tpu_torch.preempt.degraded",
              "karpenter_tpu_torch.repack.degraded",
              "karpenter_tpu_torch.whatif.degraded",
              # the catalog intake: the leaf infrastructure and the
              # catalog half of the cloud layer
              "karpenter_tpu_torch.constants",
              "karpenter_tpu_torch.version",
              "karpenter_tpu_torch.utils.cache",
              "karpenter_tpu_torch.utils.batcher",
              "karpenter_tpu_torch.core.window",
              "karpenter_tpu_torch.core.circuitbreaker",
              "karpenter_tpu_torch.catalog.unavailable",
              "karpenter_tpu_torch.catalog.pricing",
              "karpenter_tpu_torch.catalog.instancetype",
              "karpenter_tpu_torch.stochastic.risk",
              "karpenter_tpu_torch.cloud",
              "karpenter_tpu_torch.cloud.errors",
              "karpenter_tpu_torch.cloud.retry",
              "karpenter_tpu_torch.cloud.profile",
              "karpenter_tpu_torch.cloud.resources",
              "karpenter_tpu_torch.cloud.fake",
              "karpenter_tpu_torch.apis.nodeclass",
              "karpenter_tpu_torch.explain",
              "karpenter_tpu_torch.obs.slo",
              # the provisioning loop with the two cloud providers it
              # needs and the crash-recovery plane
              "karpenter_tpu_torch.apis.nodeclaim",
              "karpenter_tpu_torch.apis.pod",
              "karpenter_tpu_torch.core",
              "karpenter_tpu_torch.core.cluster",
              "karpenter_tpu_torch.cloud.image",
              "karpenter_tpu_torch.cloud.subnet",
              "karpenter_tpu_torch.core.cloudinit",
              "karpenter_tpu_torch.core.bootstrap",
              "karpenter_tpu_torch.core.actuator",
              "karpenter_tpu_torch.core.kubelet",
              "karpenter_tpu_torch.core.drift",
              "karpenter_tpu_torch.core.cloudprovider",
              "karpenter_tpu_torch.core.provisioner",
              "karpenter_tpu_torch.recovery",
              "karpenter_tpu_torch.recovery.crashpoints",
              "karpenter_tpu_torch.recovery.journal",
              "karpenter_tpu_torch.recovery.reconciler",
              # the controller runtime, its controllers and leader
              # election
              "karpenter_tpu_torch.controllers",
              "karpenter_tpu_torch.controllers.runtime",
              "karpenter_tpu_torch.controllers.nodeclaim",
              "karpenter_tpu_torch.controllers.nodeclass",
              "karpenter_tpu_torch.controllers.bootstrap",
              "karpenter_tpu_torch.controllers.faults",
              "karpenter_tpu_torch.controllers.disruption",
              "karpenter_tpu_torch.controllers.preemption",
              "karpenter_tpu_torch.controllers.gang",
              "karpenter_tpu_torch.core.leaderelection",
              # the gRPC solver sidecar and the chaos harness
              "karpenter_tpu_torch.service",
              "karpenter_tpu_torch.chaos",
              "karpenter_tpu_torch.chaos.__main__",
              "karpenter_tpu_torch.chaos.clock",
              "karpenter_tpu_torch.chaos.cloud",
              "karpenter_tpu_torch.chaos.crash",
              "karpenter_tpu_torch.chaos.invariants",
              "karpenter_tpu_torch.chaos.profile",
              "karpenter_tpu_torch.chaos.runner",
              "karpenter_tpu_torch.chaos.soak",
              "karpenter_tpu_torch.chaos.solver",
              "karpenter_tpu_torch.chaos.trace",
              # the what-if planning service and the IKS, load-balancer
              # and HTTP half of the cloud layer
              "karpenter_tpu_torch.whatif.forecast",
              "karpenter_tpu_torch.whatif.service",
              "karpenter_tpu_torch.whatif.__main__",
              "karpenter_tpu_torch.cloud.fake_iks",
              "karpenter_tpu_torch.cloud.http",
              "karpenter_tpu_torch.cloud.vpc",
              "karpenter_tpu_torch.cloud.iks",
              "karpenter_tpu_torch.cloud.loadbalancer",
              "karpenter_tpu_torch.cloud.stub",
              "karpenter_tpu_torch.cloud.client_manager",
              "karpenter_tpu_torch.core.workerpool",
              "karpenter_tpu_torch.core.factory",
              "karpenter_tpu_torch.controllers.iks",
              "karpenter_tpu_torch.controllers.loadbalancer"):
        assert m in res["modules"]


def test_native_twin_builds_from_the_port_source_alone():
    """The per-pod C++ twin is the port's own file, built with g++ into
    the port's build directory: never the reference's native/ tree."""
    from karpenter_tpu_torch import cuda_build, native

    assert native.SOURCE == cuda_build.CSRC_DIR / "ffd_host.cpp"
    assert native.library_path().parent == cuda_build.BUILD_DIR
    text = (REPO / "karpenter_tpu_torch" / "native.py").read_text()
    assert "make" not in text.split() and "native/build" not in text


def test_prefix_trap_is_handled():
    """The name filter must not confuse the port with the reference."""
    names = ["karpenter_tpu_torch", "karpenter_tpu_torch.solver",
             "karpenter_tpu", "karpenter_tpu.solver"]
    ref = [m for m in names
           if m == "karpenter_tpu" or m.startswith("karpenter_tpu.")]
    assert ref == ["karpenter_tpu", "karpenter_tpu.solver"]


def test_default_solver_needs_cuda(monkeypatch):
    """TorchSolver() runs on the card: with no CUDA device it raises
    instead of carrying on on the CPU."""
    from karpenter_tpu_torch import TorchSolver, make_solver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSolver()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_solver()
    from karpenter_tpu_torch import SolverOptions

    with pytest.raises(RuntimeError, match="CUDA"):
        make_solver(SolverOptions(sharded=2))


def test_chip_smoke_refuses_without_cuda():
    """Without a card chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
