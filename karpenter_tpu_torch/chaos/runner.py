"""Scenario soak runner: seeded chaos through the deterministic sync path.

One scenario = one :class:`ChaosHarness`: a full provisioning stack
(fake cloud behind :class:`ChaosCloud`, actuator, greedy solver behind
the production degraded-mode wrapper, fault-ring + lifecycle
controllers) driven strictly single-threaded — ``provision_once()`` +
``ControllerManager.sync()`` on a :class:`VirtualClock`, never
``start()``.  Rounds alternate workload waves, chaos ticks, a
provision/join/sync pump, and invariant checks; then a quiesce phase
lifts all faults and advances virtual time past every TTL so the
*eventual* invariants (blackouts expire, pods resolve) become checkable.

Determinism is enforced, not assumed: ``run_matrix`` executes every
(profile, seed) cell twice and compares trace digests.  Any failure
prints the exact replay command.

Port of ``karpenter_tpu/chaos/runner.py``.  The harness's device planes
(the resident store, the sharded service, the serving loop's
``TorchSolver``) run on ``device``: "cuda" unless the caller asks for
the CPU, where each degrades as the reference's does.  On the card a
device fault the profile injects raises out of the pump (the port hands
no window on the card to a host oracle); the provisioning solver stays
the reference's host stack (``ValidatingSolver(ResilientSolver(
UnstableSolver(GreedySolver)))``).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path

from karpenter_tpu_torch.apis.nodeclass import (
    InstanceRequirements, NodeClass, NodeClassSpec, PlacementStrategy,
)
from karpenter_tpu_torch.apis.pod import ResourceRequests, make_pods
from karpenter_tpu_torch.apis.podgroup import PodGroup
from karpenter_tpu_torch.catalog.instancetype import InstanceTypeProvider
from karpenter_tpu_torch.catalog.pricing import PricingProvider
from karpenter_tpu_torch.catalog.unavailable import UnavailableOfferings
from karpenter_tpu_torch.chaos.clock import VirtualClock
from karpenter_tpu_torch.chaos.cloud import ChaosCloud
from karpenter_tpu_torch.chaos.invariants import InvariantChecker, Violation
from karpenter_tpu_torch.chaos.profile import (
    PROFILES, ChaosProfile, get_profile,
)
from karpenter_tpu_torch.chaos.solver import UnstableSolver, ValidatingSolver
from karpenter_tpu_torch.chaos.trace import EventTrace
from karpenter_tpu_torch.cloud.fake import FakeCloud
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.controllers.faults import (
    InterruptionController, OrphanCleanupController, SpotPreemptionController,
)
from karpenter_tpu_torch.controllers.nodeclaim import (
    GarbageCollectionController, NodeClaimTerminationController,
    RegistrationController, StartupTaintController, TaggingController,
)
from karpenter_tpu_torch.controllers.gang import GangAdmissionController
from karpenter_tpu_torch.controllers.preemption import PreemptionController
from karpenter_tpu_torch.controllers.runtime import ControllerManager
from karpenter_tpu_torch.device import holds_card
from karpenter_tpu_torch.core.actuator import Actuator
from karpenter_tpu_torch.core.circuitbreaker import (
    CircuitBreakerConfig, CircuitBreakerManager,
)
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.core.kubelet import FakeKubelet
from karpenter_tpu_torch.core.provisioner import (
    Provisioner, ProvisionerOptions,
)
from karpenter_tpu_torch.faulttol import DeviceFaultError
from karpenter_tpu_torch.solver.degraded import ResilientSolver
from karpenter_tpu_torch.solver.greedy import GreedySolver
from karpenter_tpu_torch.solver.types import SolverOptions

# pod size menu (cpu_milli, memory_mib) — drawn per wave by the seeded
# world stream
_POD_SIZES = ((250, 512), (500, 1024), (1000, 2048), (2000, 4096))

REPLAY_FMT = ("python -m karpenter_tpu_torch.chaos --profile {profile} "
              "--seed {seed} --rounds {rounds}")


@dataclass
class ResidentProbe:
    """What the resident-state invariant needs: the harness's store plus
    callables re-listing the tracked window's inputs from ClusterState
    at CHECK time (the rebuild must be ground truth, not a cached echo
    of what the store saw)."""

    store: object
    window_pods: object       # () -> list[PodSpec]
    catalog: object           # () -> CatalogArrays | None


@dataclass
class StochasticProbe:
    """What the oversubscription invariants need: the profile's epsilon
    bound, a catalog getter (allocatable + offering lookup at CHECK
    time), the risk model the harness actually priced with, and the
    seed for the deterministic usage draws."""

    eps: float
    catalog: object           # () -> CatalogArrays | None
    model: object             # () -> SpotRiskModel | None
    seed: int = 0


@dataclass
class ShardedProbe:
    """What the shards-converge invariant needs: the harness's sharded
    service plus callables re-listing the tracked window and catalog
    from ClusterState at CHECK time (the rebuild is ground truth, not
    an echo of what the service saw).  ``stuck_rounds`` accumulates the
    consecutive rounds the rebalance collective asked for migrations it
    then failed to apply — skew that provably never drains."""

    service: object
    window_pods: object       # () -> list[PodSpec]
    catalog: object           # () -> CatalogArrays | None
    stuck_rounds: int = 0


@dataclass
class RepackProbe:
    """What the repack-plan-valid invariant needs: the harness's
    DisruptionController (its ``repack_log`` / ``repack_violations`` are
    the executed-plan ground truth, drained per round) plus a catalog
    getter for re-deriving target capacity and torus geometry."""

    controller: object
    catalog: object           # () -> CatalogArrays | None


@dataclass
class FaulttolProbe:
    """What the device-fault invariants need: the process health board
    (final-state ground truth for health-converges), the injector (the
    fault schedule actually applied), the resident store and sharded
    service whose window accounting no-window-lost audits, and the
    harness's own pump count (``windows_expected``) as the independent
    beat ledger."""

    board: object
    injector: object          # FaultyDeviceInjector or None
    resident: object          # ResidentStore or None
    sharded: object           # ResilientShardedService or None
    windows_expected: int = 0


@dataclass
class ServingProbe:
    """What the serving invariants need: the harness's ServingLoop
    (window routing ledger + ring state + replay oracle), a catalog
    getter for the generation check, the harness's own submit count
    (``windows_expected``, the independent beat ledger), the plans that
    actually came back (``plans_received``), and the host-oracle
    completions the pump took when the loop's own fallback ladder
    faulted again (still completed — never lost)."""

    loop: object
    catalog: object           # () -> CatalogArrays | None
    windows_expected: int = 0
    plans_received: int = 0
    host_oracle: int = 0


def _make_serving_loop(solver, broken: bool):
    """The harness's ServingLoop — or, for the ``broken-ring`` fixture,
    a subclass that flips one host-mirror word after every kick while
    the device state and replay oracle stay honest: the ring-converges
    invariant MUST fire (falsifiability, the broken-fixture pattern)."""
    from karpenter_tpu_torch.serving.service import ServingLoop

    if not broken:
        return ServingLoop(solver)

    class BrokenRingLoop(ServingLoop):
        def _kick(self, *args, **kwargs):
            pend = super()._kick(*args, **kwargs)
            if self.buf.mirror is not None and self.buf.mirror.size:
                self.buf.mirror[0] ^= 1
            return pend

    return BrokenRingLoop(solver)


@dataclass
class ScenarioResult:
    profile: str
    seed: int
    rounds: int
    violations: list[Violation]
    trace: EventTrace
    digest: str
    # flight-recorder span dump (JSON-safe dicts): the causal record
    # behind any violation — dumped next to the event trace on failure
    spans: list = None
    # the harness itself (post-run inspection: health board, injector
    # counts, window accounting) — tools/failover_check and the
    # faulttol tests read it; stays out of any serialized artifact
    harness: object = None

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def replay(self) -> str:
        return REPLAY_FMT.format(profile=self.profile, seed=self.seed,
                                 rounds=self.rounds)

    def render_failure(self) -> str:
        lines = [f"CHAOS FAILURE scenario={self.profile} seed={self.seed} "
                 f"({len(self.violations)} violations)"]
        lines += [f"  {v.render()}" for v in self.violations[:10]]
        if len(self.violations) > 10:
            lines.append(f"  ... +{len(self.violations) - 10} more")
        lines.append(f"replay: {self.replay}")
        return "\n".join(lines)


class ChaosHarness:
    """One scenario's stack + round loop (see module docstring)."""

    def __init__(self, profile: ChaosProfile, seed: int, *,
                 rounds: int = 10, step: float = 60.0,
                 quiesce_rounds: int = 4, quiesce_step: float = 1200.0,
                 clock: VirtualClock | None = None, device="cuda"):
        from karpenter_tpu_torch.device import resolve_device

        self.profile = profile
        # the device planes' device: resolved here, so a harness meant
        # for the card raises without one
        self.device = resolve_device(device)
        self.seed = seed
        self.rounds = rounds
        self.step = step
        self.quiesce_rounds = quiesce_rounds
        self.quiesce_step = quiesce_step
        # injected clock (the soak measures each segment's virtual span
        # to concatenate segments onto one day timeline); default is a
        # fresh clock per run, same as always
        self._inject_clock = clock
        # independent streams so cloud faults, workload shaping, and
        # solver faults cannot perturb each other's schedules
        self.rng_world = random.Random(f"{profile.name}:{seed}:world")

    # -- stack construction --------------------------------------------------

    def build(self) -> None:
        profile, seed = self.profile, self.seed
        self.clock = self._inject_clock or VirtualClock()
        self.trace = EventTrace()
        # gang profiles need accelerator types (torus dims for slice
        # placement); other profiles keep the default catalog so their
        # schedules are untouched
        gang_profiles = None
        if profile.gang_wave_rate or profile.pod_gpu:
            from karpenter_tpu_torch.cloud.fake import generate_profiles

            # gx3 first: the ladder is truncated at 24 types, and the
            # accelerator family must reach the big-chip rungs (a 2x2x2
            # slice needs an 8-chip torus, i.e. a 64-cpu gx3)
            gang_profiles = generate_profiles(
                24, families=("gx3", "bx2", "cx2"))
        self.fake = FakeCloud(region="us-south", profiles=gang_profiles)
        self.chaos_cloud = ChaosCloud(
            self.fake, profile,
            random.Random(f"{profile.name}:{seed}:cloud"),
            clock=self.clock, trace=self.trace)
        self.unavailable = UnavailableOfferings(clock=self.clock.monotonic)
        self.pricing = PricingProvider(self.fake)
        # catalog/pricing read the RAW fake: the chaos seam is the
        # provisioning/controller surface; a huge catalog TTL keeps the
        # pricing batcher thread out of the traced window entirely
        self.catalog_provider = InstanceTypeProvider(
            self.fake, self.pricing, self.unavailable,
            catalog_ttl=1e9, clock=self.clock.monotonic)
        self.cluster = ClusterState()
        nc = NodeClass(name="default", spec=NodeClassSpec(
            region="us-south", image="img-1", vpc="vpc-1",
            instance_requirements=InstanceRequirements(min_cpu=2),
            placement_strategy=PlacementStrategy()))
        nc.status.resolved_image_id = "img-1"
        nc.status.set_condition("Ready", "True", "ChaosHarness")
        self.cluster.add_nodeclass(nc)
        self.nodeclass = nc
        breaker = CircuitBreakerManager(CircuitBreakerConfig(
            failure_threshold=10**6, rate_limit_per_minute=10**6,
            max_concurrent_instances=10**6))
        self.actuator = Actuator(self.chaos_cloud, self.cluster,
                                 breaker=breaker,
                                 unavailable=self.unavailable)
        opts = SolverOptions(backend="greedy")
        self.unstable = UnstableSolver(
            GreedySolver(opts),
            random.Random(f"{profile.name}:{seed}:solver"),
            profile.solver_failure_rate, trace=self.trace)
        # the PRODUCTION degraded-mode wrapper sits under the harness's
        # independent validation oracle
        self.solver = ValidatingSolver(ResilientSolver(self.unstable, opts),
                                       trace=self.trace)
        self.provisioner = Provisioner(
            self.cluster, self.catalog_provider, self.actuator,
            ProvisionerOptions(solver=opts), device=self.device)
        self.provisioner.solver = self.solver
        # fixture-only broken applier: strip affinity from the solver's
        # view (the cluster keeps the originals) — the
        # affinity-satisfied invariant must catch the resulting
        # co-located antagonists (falsifiability)
        if profile.break_affinity:
            from karpenter_tpu_torch.chaos.solver import AffinityBlindSolver

            self.provisioner.solver = AffinityBlindSolver(self.solver)
        # genuine overload: a live-instance quota far below demand makes
        # creates fail until quiesce lifts it — pending pods can only
        # move via the preemption plane meanwhile
        self._default_quota = self.fake.instance_quota
        if profile.instance_quota:
            self.fake.instance_quota = profile.instance_quota
        # spot-risk state is PROCESS-GLOBAL (the ledger history feeds
        # the model the provisioner prices from): every seeded run must
        # start from an empty history and an empty model, or
        # determinism-verify reruns would learn run 1's rates and pack
        # differently — reset for EVERY profile, since any spot storm
        # now feeds the learning loop
        from karpenter_tpu_torch.stochastic.risk import refresh_from_ledger

        obs.get_ledger().reset_interruption_history()
        # the arrival-history ring (whatif/forecast.py) is process-global
        # the same way: a rerun learning run 1's arrival table would
        # forecast differently, breaking determinism-verify
        obs.get_ledger().reset_arrival_history()
        refresh_from_ledger(obs.get_ledger())
        # oversubscription (karpenter_tpu/stochastic): arm the default
        # pool's violation-probability bound — every solve window now
        # lowers usage distributions and packs chance-constrained
        self.risk_model = None
        if profile.overcommit_eps:
            from karpenter_tpu_torch.apis.nodeclaim import NodePool

            self.cluster.add_nodepool(NodePool(
                name="default", nodeclass_name="default",
                overcommit=profile.overcommit_eps))
        # min_pending_age=0: the pump provisions before every sync, so a
        # still-unnominated pod HAS had its create chance this round
        self.preemption = PreemptionController(
            self.cluster, self.provisioner, min_pending_age=0.0,
            device=self.device)
        # gang plane on the virtual clock; registers the provisioner's
        # admission gate (parks sub-min_member + slice gangs)
        self.gang = GangAdmissionController(
            self.cluster, self.provisioner, clock=self.clock.time,
            device=self.device)
        self._gang_backlog: list[tuple[int, list]] = []   # (round, pods)
        self._gang_seq = 0
        self._aff_seq = 0
        # resident-state store tracked through every pump beat: the
        # chaos matrix exercises the store's delta/invalidation machinery
        # (blackouts bump availability generations, churn drives deltas)
        # under the resident-state-fresh invariant — rebuilt from
        # ClusterState and compared word-for-word between sync rounds
        from karpenter_tpu_torch.resident.store import ResidentStore

        self.resident = ResidentStore(self.device)
        # sharded continuous-solve plane (karpenter_tpu/sharded): a
        # shadow service tracked through every pump — admit the pending
        # window, one stacked shard_map solve, one rebalance collective
        # tick — under the shards-converge invariant (state rebuilt from
        # ClusterState word-for-word, skew provably drained)
        self.sharded = None
        if profile.shard_count:
            from karpenter_tpu_torch.sharded import ShardedSolveService
            from karpenter_tpu_torch.sharded.degraded import (
                ResilientShardedService,
            )

            # the PRODUCTION degraded wrapper, same as the solver above:
            # a device-faulted window must degrade to the host oracle,
            # never fail the pump (no-window-lost)
            self.sharded = ResilientShardedService(
                ShardedSolveService(profile.shard_count,
                                    device=self.device))
        # serving plane (karpenter_tpu/serving): a persistent
        # device-resident ServingLoop shadow-tracked through every pump
        # beat — the pending window encodes, delta-streams through the
        # input ring, and the PREVIOUS beat's plan is fetched after this
        # beat's kick (depth-1 pipelining: every fetch's D2H overlaps a
        # later window's compute) — under the no-window-lost-serving
        # and ring-converges invariants.  It runs on the harness's
        # device, as the sharded and resident planes do.
        self.serving = None
        self.serving_probe = None
        self._serving_handles: list = []    # (handle, problem) in flight
        if profile.serving:
            from karpenter_tpu_torch.solver.torch_backend import TorchSolver

            self.serving = _make_serving_loop(
                TorchSolver(SolverOptions(backend="torch"),
                            device=self.device),
                profile.break_ring)
            # independent host oracle, the pump's LAST fallback rung: a
            # classic re-solve after a kick fault can itself fault, and
            # the window must still complete (no-window-lost-serving)
            self._serving_host = GreedySolver(
                SolverOptions(backend="greedy"))
            self.serving_probe = ServingProbe(
                loop=self.serving,
                catalog=lambda: self.provisioner._catalog_for(
                    self.nodeclass))
        # migration-first repack plane (fragmentation profile): the
        # PRODUCTION DisruptionController, defrag scoring live, every
        # executed plan logged for the repack-plan-valid invariant
        self.disruption = None
        if profile.repack:
            from karpenter_tpu_torch.apis.nodeclaim import NodePool
            from karpenter_tpu_torch.controllers.disruption import (
                DisruptionController,
            )
            from karpenter_tpu_torch.core.cloudprovider import CloudProvider

            # single-node consolidation OFF for this profile: it would
            # greedily merge the singleton scatter every round, racing
            # the batched repack plane this profile exists to exercise
            self.cluster.add_nodepool(NodePool(
                name="default", nodeclass_name="default",
                consolidation_policy="Never"))

            self.disruption = DisruptionController(
                self.cluster,
                CloudProvider(self.cluster, actuator=self.actuator,
                              instance_types=self.catalog_provider),
                provisioner=self.provisioner, clock=self.clock.time,
                repack_enabled=True, repack_cooldown=0.0,
                resident_occupancy=True,
                # migration-only: the blue/green rebuild's rollback
                # re-pends pods, which would race the round clock at the
                # final pump (and its create bursts fight the quota the
                # profile imposes on purpose)
                repack_rebuild=False, device=self.device)
        self.kubelet = FakeKubelet(self.cluster, self.fake)
        self.manager = ControllerManager(self.cluster)
        for ctrl in self._controllers():
            if ctrl.name in profile.disable_controllers:
                self.trace.add("config", disabled_controller=ctrl.name)
                continue
            self.manager.register(ctrl)
        # device-fault plane (karpenter_tpu/faulttol): pristine health
        # board per scenario, then the seeded injector for profiles that
        # arm it — its stream is independent of cloud/world/solver, so a
        # device-fault schedule never perturbs the other schedules
        from karpenter_tpu_torch.faulttol import (
            FaultyDeviceInjector, clear_injector, get_health_board,
            install_injector,
        )

        clear_injector()
        get_health_board().reset()
        self.injector = None
        if profile.device_fault_rates:
            self.injector = FaultyDeviceInjector(
                random.Random(f"{profile.name}:{seed}:device"),
                profile.device_fault_rates, trace=self.trace)
            install_injector(self.injector)
        self.ft_probe = FaulttolProbe(
            board=get_health_board(), injector=self.injector,
            resident=self.resident, sharded=self.sharded)
        gc_grace = GarbageCollectionController.min_instance_age
        reg_timeout = GarbageCollectionController.registration_timeout
        self.checker = InvariantChecker(
            self.cluster, self.fake, self.unavailable,
            orphan_grace=gc_grace + 3 * self.step + 30.0,
            stuck_claim_grace=(reg_timeout
                               + 2 * max(self.step, self.quiesce_step) + 60.0),
            solver_violations=self.solver.violations, trace=self.trace,
            explain_violations=self.solver.explain_violations,
            preemption=self.preemption
            if "preemption" not in profile.disable_controllers else None,
            gang=self.gang
            if "gang" not in profile.disable_controllers else None,
            resident=ResidentProbe(
                store=self.resident,
                window_pods=self._resident_window,
                catalog=lambda: self.provisioner._catalog_for(
                    self.nodeclass)),
            repack=RepackProbe(
                controller=self.disruption,
                catalog=lambda: self.provisioner._catalog_for(
                    self.nodeclass))
            if self.disruption is not None else None,
            sharded=ShardedProbe(
                service=self.sharded,
                window_pods=self._resident_window,
                catalog=lambda: self.provisioner._catalog_for(
                    self.nodeclass))
            if self.sharded is not None else None,
            stochastic=StochasticProbe(
                eps=profile.overcommit_eps,
                catalog=lambda: self.provisioner._catalog_for(
                    self.nodeclass),
                model=lambda: self.risk_model,
                seed=seed)
            if profile.overcommit_eps else None,
            faulttol=self.ft_probe,
            serving=self.serving_probe,
            affinity=bool(profile.affinity_wave_rate))
        # warm the catalog before chaos arms (pricing resolution happens
        # here, outside the deterministic traced window)
        self.catalog_provider.list(nc)
        # warm the native extension before the virtual clock installs:
        # native.load() shells out to make, and subprocess internals poll
        # via time.sleep — under the patched clock that advances virtual
        # time nondeterministically on the FIRST ffd_solve of a fresh
        # process, skewing the run-1 digest (run 2 hits the module cache)
        from karpenter_tpu_torch import native as _native
        _native.load()

    def _controllers(self) -> list:
        return [
            RegistrationController(self.cluster),
            StartupTaintController(self.cluster),
            NodeClaimTerminationController(self.cluster, self.actuator),
            GarbageCollectionController(self.cluster, self.chaos_cloud),
            TaggingController(self.cluster, self.chaos_cloud),
            SpotPreemptionController(self.cluster, self.chaos_cloud,
                                     self.unavailable),
            InterruptionController(self.cluster, self.unavailable,
                                   cloud=self.chaos_cloud),
            OrphanCleanupController(self.cluster, self.chaos_cloud,
                                    enabled=True),
            self.preemption,
            self.gang,
        ] + ([self.disruption] if self.disruption is not None else [])

    # -- round loop ----------------------------------------------------------

    def run(self) -> list[Violation]:
        self.build()
        violations: list[Violation] = []
        try:
            # scenario-scoped tracer: fresh deterministic span ids per
            # run, and the recorder anchor is taken INSIDE the installed
            # virtual clock so span offsets ride scenario time (spans
            # deliberately stay OUT of the EventTrace digest — the span
            # layer is evidence, the event trace is the determinism
            # contract)
            with self.clock.installed(), \
                    obs.use(obs.Tracer(obs.FlightRecorder(
                        capacity=256, error_capacity=64))) as tracer:
                self.recorder = tracer.recorder
                self._t0 = self.clock.time()
                self.chaos_cloud.arm()
                for r in range(self.rounds):
                    self.trace.add("round", n=r, t=self._vt())
                    self.chaos_cloud.tick()
                    self._inject_pods(r)
                    self._pump()
                    violations.extend(self.checker.check_round())
                    self.clock.advance(self.step)
                # quiesce: lift every fault, expire every TTL, let the
                # recovery mechanisms finish the job
                self.chaos_cloud.disarm()
                self.unstable.failure_rate = 0.0
                self.fake.instance_quota = self._default_quota
                if self.injector is not None:
                    # device faults lift with the rest: probation probes
                    # must succeed so health-converges can hold at final
                    self.injector.disarm()
                for q in range(self.quiesce_rounds):
                    self.clock.advance(self.quiesce_step)
                    self.trace.add("round", n=self.rounds + q, t=self._vt(),
                                   quiesce=True)
                    self._pump()
                    violations.extend(self.checker.check_round())
                catalog = self.provisioner._catalog_for(self.nodeclass)
                violations.extend(self.checker.check_final(catalog))
        finally:
            self.pricing.close()
            if self.injector is not None:
                # a device fault that raised out of the scenario (on the
                # card) leaves no armed injector behind in the process
                self.injector.disarm()
        # a persistent violation repeats every round; report each once
        seen: set = set()
        unique = [v for v in violations
                  if v not in seen and not seen.add(v)]
        return unique

    def _vt(self) -> float:
        return round(self.clock.time() - self._t0, 3)

    def _inject_pods(self, round_no: int) -> None:
        # staggered gang remainders land first (their arrival round came)
        due = [(r, pods) for r, pods in self._gang_backlog if r <= round_no]
        self._gang_backlog = [(r, pods) for r, pods in self._gang_backlog
                              if r > round_no]
        for _, pods in due:
            for pod in pods:
                self.cluster.add_pod(pod)
            self.trace.add("workload", shape="gang-remainder",
                           gang=pods[0].gang.name, pods=len(pods))
        if round_no >= self.profile.pod_waves:
            return
        lo, hi = self.profile.pods_per_wave
        n = self.rng_world.randint(lo, hi)
        cpu, mem = _POD_SIZES[self.rng_world.randrange(len(_POD_SIZES))]
        menu = self.profile.pod_priorities
        prio = menu[self.rng_world.randrange(len(menu))] if menu else 0
        if self.profile.gang_wave_rate \
                and self.rng_world.random() < self.profile.gang_wave_rate:
            self._inject_gang(round_no, prio)
            return
        if self.profile.affinity_wave_rate \
                and self.rng_world.random() < self.profile.affinity_wave_rate:
            self._inject_affinity(round_no, prio)
            return
        # hash-hot waves (shard-skew profile): craft the wave's request
        # signature so it HASHES onto shard 0 — load concentrates on one
        # shard and only the rebalance collective's ownership migrations
        # can drain it (the skew the shards-converge invariant watches)
        if self.profile.shard_hot_rate \
                and self.rng_world.random() < self.profile.shard_hot_rate:
            cpu, mem = self._hot_requests(cpu, mem)
        # accelerator-consuming singletons (fragmentation profile): each
        # wave pod draws a chip count from the menu — chips fill
        # low-first, so partial fills fragment the tori the parked gangs
        # need (exactly the scatter the repack defrag term must undo)
        gmenu = self.profile.pod_gpu
        gpu = gmenu[self.rng_world.randrange(len(gmenu))] if gmenu else 0
        selector = dict(self.profile.pod_node_selector) if gpu else {}
        # oversubscription waves: mean = frac * request, std = cv * mean
        # with cv from the menu — drawn from the seeded world stream so
        # the usage shape is part of the deterministic schedule
        usage = None
        if self.profile.pod_usage_mean_frac:
            from karpenter_tpu_torch.apis.pod import UsageDistribution

            frac = self.profile.pod_usage_mean_frac
            menu_cv = self.profile.pod_usage_cv or (0.2,)
            cv = menu_cv[self.rng_world.randrange(len(menu_cv))]
            mcpu, mmem = int(cpu * frac), int(mem * frac)
            usage = UsageDistribution(
                mean=ResourceRequests(mcpu, mmem, 0, 1),
                var=(int((cv * mcpu) ** 2), int((cv * mmem) ** 2), 0, 0))
        for pod in make_pods(n, name_prefix=f"wave{round_no}",
                             requests=ResourceRequests(cpu, mem, gpu, 1),
                             priority=prio, node_selector=selector,
                             usage=usage):
            self.cluster.add_pod(pod)
        # the pod-event end of the causal chain (chaos drives
        # provision_once directly, so there is no watch feed to stamp it)
        obs.instant("pod.event", wave=round_no, pods=n, cpu=cpu, mem=mem,
                    priority=prio)
        self.trace.add("workload", wave=round_no, pods=n, cpu=cpu, mem=mem,
                       gpu=gpu, priority=prio)

    def _inject_gang(self, round_no: int, prio: int) -> None:
        """One gang wave: full, staggered over two rounds, or starved
        (the remainder never arrives — the deadline-release path)."""
        p = self.profile
        size = p.gang_sizes[self.rng_world.randrange(len(p.gang_sizes))]
        shape = p.gang_slice_shapes[
            self.rng_world.randrange(len(p.gang_slice_shapes))]
        self._gang_seq += 1
        name = f"gang-{self._gang_seq}"
        # deadline sized in scenario rounds: long enough for a staggered
        # remainder (next round) to beat it, short enough that a starved
        # gang releases well inside the chaos window
        gang = PodGroup(name=name, min_member=size,
                        slice_shape=shape or None,
                        deadline_seconds=2.5 * self.step)
        # members sized small so a full gang fits one accelerator node
        pods = make_pods(size, name_prefix=name,
                         requests=ResourceRequests(250, 512, 0, 1),
                         priority=prio, gang=gang)
        arrive_now = pods
        mode = "full"
        if self.rng_world.random() < p.gang_stagger_rate:
            half = max(1, size // 2)
            arrive_now = pods[:half]
            if self.rng_world.random() < p.gang_starve_rate:
                mode = "starved"       # remainder never arrives
            else:
                mode = "staggered"
                self._gang_backlog.append((round_no + 1, pods[half:]))
        for pod in arrive_now:
            self.cluster.add_pod(pod)
        obs.instant("pod.event", wave=round_no, gang=name,
                    pods=len(arrive_now), mode=mode)
        self.trace.add("workload", wave=round_no, shape="gang", gang=name,
                       members=size, arrived=len(arrive_now),
                       slice=shape, mode=mode)

    def _inject_affinity(self, round_no: int, prio: int) -> None:
        """One affinity ensemble wave (karpenter_tpu/affinity), shape
        drawn from the seeded world stream:

        - ``required``: an anchor pair plus a follower pair carrying a
          required hostname edge to the anchors — the whole quad
          co-locates on ONE node, so a failed create leaves it pending
          WHOLE (atomic: no half-bound ensemble can strand a required
          edge across windows);
        - ``anti``: a mutual hostname anti-affinity pair — must land on
          two different nodes;
        - ``spread``: one group self-selected under a bounded hostname
          spread (max_skew 2) — at most 2 matching pods per node.

        Selector labels are per-wave unique (``affN-...``), so edges
        never reach across waves and every ensemble re-solves
        self-contained if its create fails."""
        from karpenter_tpu_torch.apis.pod import (
            HOSTNAME_TOPOLOGY_KEY, PodAffinityTerm, TopologySpreadConstraint,
        )

        self._aff_seq += 1
        tag = f"aff{self._aff_seq}"
        shape = ("required", "anti", "spread")[self.rng_world.randrange(3)]
        req = ResourceRequests(250, 512, 0, 1)
        if shape == "required":
            pods = make_pods(2, name_prefix=f"{tag}-anchor", requests=req,
                             priority=prio, labels=((tag, "anchor"),))
            pods += make_pods(
                2, name_prefix=f"{tag}-follower", requests=req,
                priority=prio, labels=((tag, "follower"),),
                affinity=(PodAffinityTerm(
                    label_selector=((tag, "anchor"),),
                    topology_key=HOSTNAME_TOPOLOGY_KEY),))
        elif shape == "anti":
            pods = make_pods(1, name_prefix=f"{tag}-left", requests=req,
                             priority=prio, labels=((tag, "left"),),
                             affinity=(PodAffinityTerm(
                                 label_selector=((tag, "right"),),
                                 topology_key=HOSTNAME_TOPOLOGY_KEY,
                                 anti=True),))
            pods += make_pods(1, name_prefix=f"{tag}-right", requests=req,
                              priority=prio, labels=((tag, "right"),),
                              affinity=(PodAffinityTerm(
                                  label_selector=((tag, "left"),),
                                  topology_key=HOSTNAME_TOPOLOGY_KEY,
                                  anti=True),))
        else:
            pods = make_pods(
                4, name_prefix=f"{tag}-spread", requests=req,
                priority=prio, labels=((tag, "member"),),
                topology_spread=(TopologySpreadConstraint(
                    max_skew=2, topology_key=HOSTNAME_TOPOLOGY_KEY,
                    label_selector=((tag, "member"),)),))
        for pod in pods:
            self.cluster.add_pod(pod)
        obs.instant("pod.event", wave=round_no, affinity=tag,
                    pods=len(pods), shape=shape)
        self.trace.add("workload", wave=round_no, shape=f"affinity-{shape}",
                       tag=tag, pods=len(pods), priority=prio)

    def _hot_requests(self, cpu: int, mem: int) -> tuple[int, int]:
        """Smallest cpu bump whose request signature hashes to shard 0
        (deterministic: blake2 content hashing, seeded-stream-free)."""
        from karpenter_tpu_torch.sharded.router import craft_hot_requests

        return craft_hot_requests(self.profile.shard_count, 0,
                                  cpu=cpu, mem=mem, count=1)[0]

    def _pump_sharded(self, catalog) -> None:
        """One shadow beat of the sharded service: admit the pending
        window, drop resolved pods, one stacked solve, one rebalance
        collective tick — every number it produces rides the event
        trace so the determinism digest covers the plane."""
        from karpenter_tpu_torch.apis.pod import pod_key

        pending = self._resident_window()
        self.sharded.sync_backlog(pod_key(p) for p in pending)
        self.sharded.admit(pending)
        plan = self.sharded.solve_window(catalog)
        decision = self.sharded.rebalance()
        self.trace.add("sharded",
                       shard_pods=list(plan.shard_pods),
                       nodes=sum(len(p.nodes) for p in plan.plans),
                       unplaced=sum(len(p.unplaced_pods)
                                    for p in plan.plans),
                       skew=decision.skew, donor=decision.donor,
                       receiver=decision.receiver,
                       moved=len(decision.moved_keys),
                       migrations=self.sharded.migrations)

    def _pump_serving(self, window, catalog) -> None:
        """One shadow beat of the serving loop: encode the beat's
        PRE-provision pending window (the same window provision_once
        solved — successive beats share surviving pods, so churn rides
        the ring as deltas), submit it through the ring, then fetch
        back to the pipelining depth — ONE window stays in flight
        across beats while chaos is armed (its D2H overlaps the next
        beat's kick), and quiesce beats drain fully so the day ends
        with every window accounted.  A fault that escapes the loop's
        own fallback ladder (the classic re-solve can fault again)
        completes on the independent host oracle — the submit ledger
        the no-window-lost-serving invariant audits — for a loop on the
        CPU; for one on the card it raises out of the scenario."""
        from karpenter_tpu_torch.faulttol import DeviceFaultError
        from karpenter_tpu_torch.solver.encode import encode

        probe = self.serving_probe
        # catalog bumps (blackout generations) invalidate a warm ring
        # even when this beat routes classic — the stamp stays honest
        self.serving.track_generation(catalog)
        problem = encode(window, catalog)
        probe.windows_expected += 1
        self._serving_handles.append(
            (self.serving.submit(problem), problem))
        keep = 1 if self.chaos_cloud.armed else 0
        nodes = unplaced = 0
        while len(self._serving_handles) > keep:
            handle, prob = self._serving_handles.pop(0)
            try:
                plan = handle.result()
            except DeviceFaultError:
                # last rung: the fallback ladder itself faulted — the
                # window still completes, on the host oracle (never for
                # a window on the card)
                if holds_card(self.serving.solver):
                    raise
                plan = self._serving_host.solve_encoded(prob)
                probe.host_oracle += 1
            probe.plans_received += 1
            nodes += len(plan.nodes)
            unplaced += len(plan.unplaced_pods)
        # every number the loop produced rides the event trace, so the
        # determinism digest covers the serving plane beat for beat
        st = self.serving.stats()
        self.trace.add("serving",
                       windows=st["windows"], ring=st["ring_windows"],
                       classic=st["classic_windows"],
                       backpressure=st["backpressured"],
                       failover=st["host_failovers"],
                       rebuilds=st["rebuilds"],
                       invalidations=st["invalidations"],
                       mode=st["last_mode"],
                       occupancy=st["output_occupancy"],
                       fetched=probe.plans_received,
                       host_oracle=probe.host_oracle,
                       nodes=nodes, unplaced=unplaced)

    def _resident_window(self) -> list:
        """The window the resident store tracks: pending unnominated
        pods, in collection order (the same selection provision_once
        solves)."""
        return [p.spec for p in self.cluster.pending_pods()
                if not p.nominated_node]

    def _pump(self) -> None:
        """One provisioning + continuation + reconcile beat."""
        # the serving plane shadow-solves the window provision_once is
        # about to solve — capture it before the beat binds it away
        serving_window = self._resident_window() \
            if self.serving is not None else None
        self.provisioner.provision_once()
        self.kubelet.join_pending(ready=True)
        self.manager.sync(rounds=2)
        self.kubelet.bind_nominated()
        self.unavailable.cleanup()
        # track the post-beat window through the resident store (delta
        # against the previous beat's device-resident state); the round
        # invariant then rebuilds it from ClusterState and compares
        catalog = self.provisioner._catalog_for(self.nodeclass)
        if catalog is not None:
            # every window handed to the resident/sharded planes is owed
            # a solve — device-faulted or not (no-window-lost ledger)
            self.ft_probe.windows_expected += 1
            self.resident.track_window(self._resident_window(), catalog)
        if self.sharded is not None and catalog is not None:
            self._pump_sharded(catalog)
        if self.serving is not None and catalog is not None:
            self._pump_serving(serving_window, catalog)
        # spot-risk learning loop (stochastic/risk.py): re-derive the
        # model from the ledger's labeled lifecycle history and price
        # expected eviction cost into offering ranking — checked
        # against the same ledger by the risk-model-consistent
        # invariant every round
        if self.profile.overcommit_eps:
            from karpenter_tpu_torch.stochastic.risk import refresh_from_ledger

            self.risk_model = refresh_from_ledger(obs.get_ledger())
            if catalog is not None:
                self.risk_model.price_catalog(catalog)
        pods = self.cluster.list("pods")
        self.trace.add(
            "pump",
            pods=len(pods),
            bound=sum(1 for p in pods if p.bound_node),
            claims=sum(1 for c in self.cluster.nodeclaims() if not c.deleted),
            instances=self.fake.instance_count(),
            blackouts=len(self.unavailable.unavailable_keys()),
            preempted=len(self.preemption.preempted_keys),
            gangs_admitted=len(self.gang.admitted),
            gangs_released=len(self.gang.released))


def run_scenario(profile: ChaosProfile | str, seed: int, *,
                 rounds: int = 10, **kwargs) -> ScenarioResult:
    from karpenter_tpu_torch.obs.export import recorder_to_dicts

    prof = get_profile(profile) if isinstance(profile, str) else profile
    harness = ChaosHarness(prof, seed, rounds=rounds, **kwargs)
    violations = harness.run()
    return ScenarioResult(profile=prof.name, seed=seed, rounds=rounds,
                          violations=violations, trace=harness.trace,
                          digest=harness.trace.digest(),
                          spans=recorder_to_dicts(harness.recorder),
                          harness=harness)


def run_matrix(profile_names: list[str] | None = None,
               seeds: tuple[int, ...] = (1, 2, 3, 4), *,
               rounds: int = 10, verify_determinism: bool = True,
               trace_dir: str | None = None, echo=print,
               device="cuda") -> tuple[list[ScenarioResult], list[str]]:
    """Run profiles x seeds; returns (results, failure messages).

    Each cell runs TWICE when ``verify_determinism`` — identical trace
    digests are the acceptance bar for "same seed => same run".  On any
    failure the trace is dumped under ``trace_dir`` (the CI artifact)
    and the replay command printed; a cell whose device fault raised (on
    the card) fails with its replay command.
    """
    names = profile_names if profile_names is not None else list(PROFILES)
    results: list[ScenarioResult] = []
    failures: list[str] = []
    for name in names:
        for seed in seeds:
            try:
                res = run_scenario(name, seed, rounds=rounds, device=device)
            except DeviceFaultError as e:
                # a device fault on the card raises out of the scenario:
                # the cell fails, with the command that replays it
                msg = (f"CHAOS DEVICE FAULT scenario={name} seed={seed}: "
                       f"{e}\nreplay: " + REPLAY_FMT.format(
                           profile=name, seed=seed, rounds=rounds))
                failures.append(msg)
                echo(msg)
                continue
            results.append(res)
            problems = []
            res2 = None
            if verify_determinism:
                res2 = run_scenario(name, seed, rounds=rounds,
                                    device=device)
                if res2.digest != res.digest:
                    problems.append(
                        f"NONDETERMINISTIC scenario={name} seed={seed}: "
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
                    path = Path(trace_dir) / f"{name}-seed{seed}.jsonl"
                    res.trace.dump(path)
                    echo(f"trace: {path}")
                    # the implicated flight-recorder traces land next to
                    # the fault trace: the causal chain (pod event ->
                    # provision -> solve -> actuation -> RPC attempts)
                    # behind the violation, Perfetto-convertible via
                    # `python -m karpenter_tpu_torch.obs export --input ...`
                    from karpenter_tpu_torch.obs.export import dump_jsonl

                    span_path = Path(trace_dir) / \
                        f"{name}-seed{seed}-spans.jsonl"
                    dump_jsonl(res.spans or [], span_path)
                    echo(f"spans: {span_path}")
                    if res2 is not None and res2.digest != res.digest:
                        # both runs: diagnosing nondeterminism needs the
                        # divergent trace, not just the first
                        path2 = Path(trace_dir) / f"{name}-seed{seed}-run2.jsonl"
                        res2.trace.dump(path2)
                        echo(f"trace: {path2}")
            else:
                echo(f"ok   {name:<16} seed={seed} events={len(res.trace):<4} "
                     f"digest={res.digest[:12]}")
    echo(f"chaos matrix: {len(results)} scenarios, "
         f"{len(failures)} failures")
    return results, failures
