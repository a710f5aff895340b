"""Crashpoint chaos: kill + restart the operator at seeded crashpoints.

The third chaos dimension (after cloud faults and solver faults): the
operator *process itself* dies — at exactly the instants where death is
most damaging (``recovery/crashpoints.py`` catalog) — and a fresh
"process" recovers through the write-ahead journal
(docs/design/recovery.md).  One scenario = one ``(crashpoint, seed)``
cell:

- the durable world (FakeCloud ground truth + ClusterState, standing in
  for the cloud and the API server) survives every crash;
- the operator plane (actuator, provisioner, controllers, journal
  handle, preemption/gang memory) is DISCARDED on crash and rebuilt,
  with :class:`~karpenter_tpu_torch.recovery.reconciler.Reconciler` replaying
  open intents before the new plane serves;
- crashes fire deterministically from the seeded
  :class:`~karpenter_tpu_torch.recovery.crashpoints.CrashInjector`, so every
  cell is digest-reproducible (run twice, compared — same contract as
  the cloud-fault matrix).

Invariants (checked against ground truth, never the journal alone):

- ``no-double-create`` (round): no intent id ever owns two live
  instances — a replayed create must be an idempotent lookup;
- ``no-leaked-partial-create`` (final): after quiesce no VNI or volume
  floats unattached and no tagged instance lacks a claim — every
  half-built sequence was fenced or finished;
- ``no-lost-nomination`` (final): after quiesce every injected pod is
  bound — a crash between create and nominate must not strand capacity
  or pods;
- ``journal-converges`` (final): the on-disk journal drains to zero
  open intents once the world quiesces.

The ``broken-idempotency`` fixture (``idempotency=False``) disables key
derivation so a replayed create genuinely duplicates — proving the
matrix FAILS ``no-double-create`` when the mechanism is broken.

Port of ``karpenter_tpu/chaos/crash.py``: the operator plane's
provisioner and preemption controller take ``device`` ("cuda" unless
the caller asks for the CPU); every cell removes its journal directory.
"""

from __future__ import annotations

import random
import shutil
import tempfile
from dataclasses import dataclass
from pathlib import Path

from karpenter_tpu_torch.apis.nodeclass import (
    InstanceRequirements, NodeClass, NodeClassSpec, PlacementStrategy,
)
from karpenter_tpu_torch.apis.pod import ResourceRequests, make_pods
from karpenter_tpu_torch.catalog.instancetype import InstanceTypeProvider
from karpenter_tpu_torch.catalog.pricing import PricingProvider
from karpenter_tpu_torch.catalog.unavailable import UnavailableOfferings
from karpenter_tpu_torch.chaos.clock import VirtualClock
from karpenter_tpu_torch.chaos.invariants import Violation
from karpenter_tpu_torch.chaos.trace import EventTrace
from karpenter_tpu_torch.cloud.fake import FakeCloud
from karpenter_tpu_torch.controllers.faults import OrphanCleanupController
from karpenter_tpu_torch.controllers.nodeclaim import (
    GarbageCollectionController, NodeClaimTerminationController,
    RegistrationController, StartupTaintController,
)
from karpenter_tpu_torch.controllers.preemption import PreemptionController
from karpenter_tpu_torch.controllers.runtime import ControllerManager
from karpenter_tpu_torch.core.actuator import Actuator
from karpenter_tpu_torch.core.circuitbreaker import (
    CircuitBreakerConfig, CircuitBreakerManager,
)
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.core.kubelet import FakeKubelet
from karpenter_tpu_torch.core.provisioner import (
    Provisioner, ProvisionerOptions,
)
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.recovery import crashpoints
from karpenter_tpu_torch.recovery.crashpoints import (
    CRASHPOINTS, CrashInjector, SimulatedCrash,
)
from karpenter_tpu_torch.recovery.journal import IntentJournal, read_journal
from karpenter_tpu_torch.recovery.reconciler import Reconciler
from karpenter_tpu_torch.solver.types import SolverOptions

_POD_SIZES = ((250, 512), (500, 1024), (1000, 2048), (2000, 4096))
_PRIORITIES = (0, 0, 100, 1000)

CRASH_REPLAY_FMT = ("python -m karpenter_tpu_torch.chaos --crash "
                    "--crashpoint {crashpoint} --seed {seed} "
                    "--rounds {rounds}")


@dataclass
class CrashScenarioResult:
    crashpoint: str
    seed: int
    rounds: int
    crashes: int
    restarts: int
    violations: list[Violation]
    trace: EventTrace
    digest: str
    journal_text: str = ""     # final on-disk journal (the CI artifact)

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def replay(self) -> str:
        return CRASH_REPLAY_FMT.format(crashpoint=self.crashpoint,
                                       seed=self.seed, rounds=self.rounds)

    def render_failure(self) -> str:
        lines = [f"CRASH-CHAOS FAILURE crashpoint={self.crashpoint} "
                 f"seed={self.seed} ({len(self.violations)} violations, "
                 f"{self.crashes} crashes)"]
        lines += [f"  {v.render()}" for v in self.violations[:10]]
        if len(self.violations) > 10:
            lines.append(f"  ... +{len(self.violations) - 10} more")
        lines.append(f"replay: {self.replay}")
        return "\n".join(lines)


class CrashHarness:
    """One (crashpoint, seed) cell: rounds of workload + crash/restart
    cycles on the VirtualClock, then quiesce + invariant checks."""

    QUOTA = 6          # overload: creates fail -> the eviction plane works

    def __init__(self, crashpoint: str, seed: int, *, rounds: int = 8,
                 step: float = 60.0, quiesce_rounds: int = 3,
                 quiesce_step: float = 900.0, idempotency: bool = True,
                 journal_dir: str | None = None, device="cuda"):
        from karpenter_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.crashpoint = crashpoint
        self.seed = seed
        self.rounds = rounds
        self.step = step
        self.quiesce_rounds = quiesce_rounds
        self.quiesce_step = quiesce_step
        self.idempotency = idempotency
        self._journal_dir = journal_dir
        self._own_dir = journal_dir is None
        self.rng_world = random.Random(f"crash:{crashpoint}:{seed}:world")

    # -- durable world -----------------------------------------------------

    def build(self) -> None:
        self.clock = VirtualClock()
        self.trace = EventTrace()
        if self._journal_dir is None:
            self._journal_dir = tempfile.mkdtemp(prefix="ktpu-crash-")
        self.journal_path = str(Path(self._journal_dir) / "intents.jsonl")
        self.fake = FakeCloud(region="us-south")
        self._default_quota = self.fake.instance_quota
        self.fake.instance_quota = self.QUOTA
        self.cluster = ClusterState()
        nc = NodeClass(name="default", spec=NodeClassSpec(
            region="us-south", image="img-1", vpc="vpc-1",
            instance_requirements=InstanceRequirements(min_cpu=2),
            placement_strategy=PlacementStrategy()))
        nc.status.resolved_image_id = "img-1"
        nc.status.set_condition("Ready", "True", "CrashHarness")
        self.cluster.add_nodeclass(nc)
        self.nodeclass = nc
        # catalog side stays out of the crash scope (it is a derived
        # cache, not actuation state); one pricing batcher for the run
        self.unavailable = UnavailableOfferings(clock=self.clock.monotonic)
        self.pricing = PricingProvider(self.fake)
        self.catalog_provider = InstanceTypeProvider(
            self.fake, self.pricing, self.unavailable,
            catalog_ttl=1e9, clock=self.clock.monotonic)
        self.kubelet = FakeKubelet(self.cluster, self.fake)
        self.restarts = 0
        self.crashes = 0
        self._needs_boot = True
        self.catalog_provider.list(nc)     # warm outside the traced window
        # warm the native extension here too: load() shells out to make,
        # and subprocess internals poll via time.sleep — under the
        # patched clock that advances virtual time nondeterministically
        # on the FIRST ffd_solve of a fresh process (run 2 hits the
        # module cache, so only run 1 skews: exactly the digest flake)
        from karpenter_tpu_torch import native as _native
        _native.load()

    # -- the operator plane (dies on crash) --------------------------------

    def _reboot(self) -> None:
        """(Re)build everything a process restart rebuilds; on restart,
        run the ONE recover() path before the plane serves."""
        recovering = self.restarts > 0
        self.journal = IntentJournal(self.journal_path, owner="op",
                                     fsync=False,
                                     idempotency=self.idempotency)
        breaker = CircuitBreakerManager(CircuitBreakerConfig(
            failure_threshold=10**6, rate_limit_per_minute=10**6,
            max_concurrent_instances=10**6))
        self.actuator = Actuator(self.fake, self.cluster, breaker=breaker,
                                 unavailable=self.unavailable,
                                 journal=self.journal)
        self.provisioner = Provisioner(
            self.cluster, self.catalog_provider, self.actuator,
            ProvisionerOptions(solver=SolverOptions(backend="greedy")),
            journal=self.journal, device=self.device)
        self.preemption = PreemptionController(
            self.cluster, self.provisioner, min_pending_age=0.0,
            journal=self.journal, device=self.device)
        self.manager = ControllerManager(self.cluster)
        for ctrl in (
                RegistrationController(self.cluster),
                StartupTaintController(self.cluster),
                NodeClaimTerminationController(self.cluster, self.actuator),
                GarbageCollectionController(self.cluster, self.fake,
                                            journal=self.journal),
                OrphanCleanupController(self.cluster, self.fake,
                                        enabled=True, journal=self.journal),
                self.preemption):
            self.manager.register(ctrl)
        if recovering:
            report = Reconciler(self.journal, self.fake,
                                self.cluster).recover()
            self.preemption.seed_recovered(report.preempted_keys)
            self.trace.add("recovery", replayed=report.replayed,
                           finished=report.finished, fenced=report.fenced,
                           errors=report.errors,
                           nominations=report.nominations_restored)
        self._needs_boot = False

    def _crash(self, c: SimulatedCrash) -> None:
        self.crashes += 1
        self.restarts += 1
        self.trace.add("crash", point=c.crashpoint, hit=c.hit_no,
                       n=self.crashes)
        # the dying process flushes nothing further; every append
        # already hit the file, so closing the handle loses no record
        try:
            self.journal.close()
        except Exception:  # noqa: BLE001 — a dead process can't cleanup
            pass
        self._needs_boot = True

    # -- round loop --------------------------------------------------------

    def run(self) -> list[Violation]:
        self.build()
        violations: list[Violation] = []
        injector = CrashInjector(self.crashpoint, self.seed)
        try:
            with self.clock.installed(), \
                    obs.use(obs.Tracer(obs.FlightRecorder(
                        capacity=256, error_capacity=64))), \
                    crashpoints.installed(injector):
                self._t0 = self.clock.time()
                for r in range(self.rounds):
                    self.trace.add("round", n=r, t=self._vt())
                    self._inject_pods(r)
                    self._pump_with_crashes()
                    violations.extend(self._no_double_create())
                    self.clock.advance(self.step)
                # quiesce: no more crashes, quota lifts, TTLs expire
                injector.disarm()
                self.fake.instance_quota = self._default_quota
                for q in range(self.quiesce_rounds):
                    self.clock.advance(self.quiesce_step)
                    self.trace.add("round", n=self.rounds + q, t=self._vt(),
                                   quiesce=True)
                    self._pump_with_crashes()
                violations.extend(self._no_double_create())
                violations.extend(self._check_final())
        finally:
            self.pricing.close()
            try:
                self.journal.close()
            except Exception:  # noqa: BLE001 — teardown
                pass
        seen: set = set()
        return [v for v in violations if v not in seen and not seen.add(v)]

    def cleanup(self) -> None:
        if self._own_dir and self._journal_dir:
            shutil.rmtree(self._journal_dir, ignore_errors=True)
            self._journal_dir = None

    def _vt(self) -> float:
        return round(self.clock.time() - self._t0, 3)

    def _inject_pods(self, round_no: int) -> None:
        if round_no >= max(2, self.rounds - 2):
            return            # tail rounds drain instead of adding
        n = self.rng_world.randint(6, 14)
        # per-POD size/priority draws: every wave mixes priorities, so
        # under the quota squeeze high-priority stragglers always have
        # lower-priority victims to evict — the mid-eviction crashpoint
        # must actually be reachable in every cell
        for i in range(n):
            cpu, mem = _POD_SIZES[self.rng_world.randrange(len(_POD_SIZES))]
            prio = _PRIORITIES[self.rng_world.randrange(len(_PRIORITIES))]
            for pod in make_pods(1, name_prefix=f"wave{round_no}x{i}",
                                 requests=ResourceRequests(cpu, mem, 0, 1),
                                 priority=prio):
                self.cluster.add_pod(pod)
        self.trace.add("workload", wave=round_no, pods=n)

    def _pump_with_crashes(self) -> None:
        """One pump beat, surviving any number of scheduled crashes
        (including crashes DURING recovery itself — the injector's
        schedule is finite, so the loop terminates)."""
        for _ in range(16):
            try:
                if self._needs_boot:
                    self._reboot()
                self._pump()
                return
            except SimulatedCrash as c:
                self._crash(c)
        raise RuntimeError("crash loop did not terminate")

    def _pump(self) -> None:
        self.provisioner.provision_once()
        self.kubelet.join_pending(ready=True)
        self.manager.sync(rounds=2)
        self.kubelet.bind_nominated()
        self.unavailable.cleanup()
        pods = self.cluster.list("pods")
        self.trace.add(
            "pump", pods=len(pods),
            bound=sum(1 for p in pods if p.bound_node),
            claims=sum(1 for c in self.cluster.nodeclaims()
                       if not c.deleted),
            instances=self.fake.instance_count(),
            open_intents=len(self.journal.open_intents()),
            restarts=self.restarts)

    # -- invariants --------------------------------------------------------

    def _no_double_create(self) -> list[Violation]:
        by_intent: dict[str, list[str]] = {}
        for inst in self.fake.list_instances():
            iid = inst.tags.get("karpenter.sh/intent-id", "")
            if iid:
                by_intent.setdefault(iid, []).append(inst.id)
        return [Violation(
            "no-double-create",
            f"intent {iid} owns {len(ids)} live instances: {sorted(ids)}")
            for iid, ids in sorted(by_intent.items()) if len(ids) > 1]

    def _check_final(self) -> list[Violation]:
        out: list[Violation] = []
        # no-leaked-partial-create: every VNI/volume attached, every
        # tagged instance claimed
        attached_vnis = {i.vni_id for i in self.fake.list_instances()}
        attached_vols = {vid for i in self.fake.list_instances()
                         for vid in i.volume_ids}
        for vni_id in sorted(self.fake.vnis):
            if vni_id not in attached_vnis:
                out.append(Violation(
                    "no-leaked-partial-create",
                    f"VNI {vni_id} unattached after quiesce"))
        for vol_id in sorted(self.fake.volumes):
            if vol_id not in attached_vols:
                out.append(Violation(
                    "no-leaked-partial-create",
                    f"volume {vol_id} unattached after quiesce"))
        from karpenter_tpu_torch.apis.nodeclaim import parse_provider_id

        tracked = set()
        for claim in self.cluster.nodeclaims():
            parsed = parse_provider_id(claim.provider_id)
            if parsed:
                tracked.add(parsed[1])
        for node in self.cluster.nodes():
            parsed = parse_provider_id(node.provider_id)
            if parsed:
                tracked.add(parsed[1])
        for inst in self.fake.list_instances():
            if inst.tags.get("karpenter.sh/managed") == "true" \
                    and inst.id not in tracked:
                out.append(Violation(
                    "no-leaked-partial-create",
                    f"tagged instance {inst.id} untracked after quiesce"))
        # no-lost-nomination: every injected pod (all placeable by
        # construction) bound once the world quiesced
        for pending in self.cluster.pending_pods():
            if not pending.bound_node:
                out.append(Violation(
                    "no-lost-nomination",
                    f"pod {pending.spec.namespace}/{pending.spec.name} "
                    f"unbound after quiesce (nominated="
                    f"{pending.nominated_node or '-'})"))
        # journal-converges: the on-disk journal holds zero open intents
        intents, _, _, _ = read_journal(self.journal_path)
        for intent in intents:
            if not intent.outcome:
                out.append(Violation(
                    "journal-converges",
                    f"intent {intent.id} ({intent.kind}) still open "
                    f"after quiesce"))
        return out


def run_crash_scenario(crashpoint: str, seed: int, *, rounds: int = 8,
                       idempotency: bool = True,
                       device="cuda") -> CrashScenarioResult:
    harness = CrashHarness(crashpoint, seed, rounds=rounds,
                           idempotency=idempotency, device=device)
    try:
        violations = harness.run()
        journal_text = ""
        try:
            journal_text = Path(harness.journal_path).read_text()
        except OSError:
            pass
        return CrashScenarioResult(
            crashpoint=crashpoint, seed=seed, rounds=rounds,
            crashes=harness.crashes, restarts=harness.restarts,
            violations=violations, trace=harness.trace,
            digest=harness.trace.digest(), journal_text=journal_text)
    finally:
        harness.cleanup()


def run_crash_matrix(crashpoint_names: list[str] | None = None,
                     seeds: tuple[int, ...] = (1, 2, 3), *,
                     rounds: int = 8, verify_determinism: bool = True,
                     trace_dir: str | None = None, echo=print,
                     device="cuda") -> tuple[list[CrashScenarioResult],
                                             list[str]]:
    """Crashpoint x seed matrix; each cell twice with digest comparison
    (same contract as the cloud-fault matrix).  On failure the event
    trace AND the final journal are dumped under ``trace_dir``."""
    names = crashpoint_names if crashpoint_names is not None \
        else list(CRASHPOINTS)
    results: list[CrashScenarioResult] = []
    failures: list[str] = []
    for name in names:
        for seed in seeds:
            res = run_crash_scenario(name, seed, rounds=rounds,
                                     device=device)
            results.append(res)
            problems = []
            res2 = None
            if verify_determinism:
                res2 = run_crash_scenario(name, seed, rounds=rounds,
                                          device=device)
                if res2.digest != res.digest:
                    problems.append(
                        f"NONDETERMINISTIC crashpoint={name} seed={seed}: "
                        f"trace digests differ across identical runs "
                        f"({res.digest[:12]} != {res2.digest[:12]})\n"
                        f"replay: {res.replay}")
            if res.violations:
                problems.append(res.render_failure())
            if problems:
                failures.extend(problems)
                for p in problems:
                    echo(p)
                if trace_dir:
                    safe = name.replace(".", "-")
                    path = Path(trace_dir) / f"crash-{safe}-seed{seed}.jsonl"
                    res.trace.dump(path)
                    echo(f"trace: {path}")
                    jpath = Path(trace_dir) / \
                        f"crash-{safe}-seed{seed}-journal.jsonl"
                    jpath.parent.mkdir(parents=True, exist_ok=True)
                    jpath.write_text(res.journal_text)
                    echo(f"journal: {jpath}")
                    if res2 is not None and res2.digest != res.digest:
                        path2 = Path(trace_dir) / \
                            f"crash-{safe}-seed{seed}-run2.jsonl"
                        res2.trace.dump(path2)
                        echo(f"trace: {path2}")
            else:
                echo(f"ok   {name:<24} seed={seed} "
                     f"crashes={res.crashes} events={len(res.trace):<4} "
                     f"digest={res.digest[:12]}")
    echo(f"crash matrix: {len(results)} scenarios, "
         f"{len(failures)} failures")
    return results, failures
