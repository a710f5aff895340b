"""Declarative chaos profiles: what to break, how hard, how often.

A :class:`ChaosProfile` is pure data — every stochastic decision it
parameterizes is drawn from the harness's seeded ``random.Random``
stream, so a profile + seed fully determines the fault schedule.  Error
kinds name the ``cloud/errors.py`` taxonomy (429 with Retry-After, 5xx,
timeouts, not-found ...); storm knobs drive the fake cloud's
spot-preemption / health-degradation / capacity hooks so
``controllers/faults.py`` sees exactly the signals production would.

The registry ships the scenario matrix ``make chaos`` runs plus fixture
profiles (``fixture=True``) used by tests to prove the harness *fails*
when an invariant is really broken.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# weighted draw over the cloud error taxonomy (kind -> weight); kinds are
# materialized into CloudErrors by chaos/cloud.py
DEFAULT_ERROR_KINDS: tuple[tuple[str, float], ...] = (
    ("rate_limited", 3.0),       # 429 + Retry-After
    ("internal", 2.0),           # 500
    ("unavailable", 2.0),        # 503
    ("timeout", 2.0),            # 408
    ("conflict", 0.5),           # 409, non-retryable
    ("not_found", 0.5),          # 404 — the cloud lying; must self-heal
)


@dataclass(frozen=True)
class ChaosProfile:
    """One named fault-injection configuration (see docs/design/chaos.md)."""

    name: str
    description: str = ""
    # per-call error injection: method name (or "*" for any wrapped
    # method) -> probability of raising an injected CloudError
    error_rates: dict[str, float] = field(default_factory=dict)
    error_kinds: tuple[tuple[str, float], ...] = DEFAULT_ERROR_KINDS
    # injected latency in VIRTUAL seconds: method (or "*") -> (lo, hi)
    latency: dict[str, tuple[float, float]] = field(default_factory=dict)
    # list_* calls return a random subset with this probability
    partial_list_rate: float = 0.0
    # create_instance succeeds server-side but the response is "lost":
    # a tagged instance leaks with no claim (the orphan-cleanup path)
    create_leak_rate: float = 0.0
    # per-tick storms (one tick per scenario round)
    preempt_storm_rate: float = 0.0      # P(spot preemption storm this tick)
    preempt_storm_frac: float = 0.5      # P(each spot instance is hit)
    degrade_rate: float = 0.0            # P(one instance health degrades)
    capacity_blackout_rate: float = 0.0  # P(a (type, zone) loses capacity)
    capacity_blackout_rounds: int = 3    # ticks a blackout lasts
    # solver-layer failure injection (exercises the greedy degraded mode)
    solver_failure_rate: float = 0.0
    # workload shaping
    pod_waves: int = 4                   # rounds that add a pod wave
    pods_per_wave: tuple[int, int] = (8, 32)
    # mixed-priority backlog: when non-empty, each wave draws its pods'
    # priority from this menu (seeded world stream) — the preemption
    # plane's workload shape (overload profile)
    pod_priorities: tuple[int, ...] = ()
    # accelerator-consuming singleton waves: when non-empty, each
    # singleton wave draws a per-pod gpu (chip) request from this menu —
    # the fragmentation profile's scatter workload (chips fill low-first,
    # so partial fills strand contiguous slices)
    pod_gpu: tuple[int, ...] = ()
    # node selector stamped on gpu singleton waves (fragmentation pins
    # them to one big-torus type so the scatter lands on exactly the
    # tori the parked gangs need)
    pod_node_selector: dict[str, str] = field(default_factory=dict)
    # run the production DisruptionController with migration-first
    # repack enabled (repack plane + repack-plan-valid invariant armed)
    repack: bool = False
    # gang workload shaping (gang profile): probability a wave arrives
    # as a PodGroup, the member-count menu, and the slice-shape menu
    # ("" = gang without topology demand).  gang_stagger_rate makes some
    # gang waves arrive split across two rounds (exercises parking);
    # gang_starve_rate drops the second half entirely (exercises the
    # deadline release + degraded per-pod fallback).
    gang_wave_rate: float = 0.0
    gang_sizes: tuple[int, ...] = (4, 8)
    gang_slice_shapes: tuple[str, ...] = ("",)
    gang_stagger_rate: float = 0.0
    gang_starve_rate: float = 0.0
    # oversubscription workload (karpenter_tpu/stochastic): with
    # mean_frac > 0, every wave pod carries a usage distribution —
    # mean = frac * request per resource, std = cv * mean with cv drawn
    # from the menu by the seeded world stream.  overcommit_eps > 0
    # arms the "default" NodePool's violation-probability bound (the
    # solver packs by mean + z(eps)*sqrt(var)), the spot-risk pricing
    # loop, and the violation-rate-under-bound / risk-model-consistent
    # invariants.
    pod_usage_mean_frac: float = 0.0
    pod_usage_cv: tuple[float, ...] = ()
    overcommit_eps: float = 0.0
    # sharded continuous-solve plane (karpenter_tpu/sharded): with
    # shard_count > 0 the harness shadow-runs a ShardedSolveService
    # through every pump (admit pending -> stacked shard_map solve ->
    # rebalance collective) under the shards-converge invariant.
    # shard_hot_rate makes that fraction of singleton waves carry a
    # request signature CRAFTED to hash onto shard 0 (hash-hot keys) so
    # load concentrates and only the rebalance collective can drain it.
    shard_count: int = 0
    shard_hot_rate: float = 0.0
    # affinity plane (karpenter_tpu/affinity): probability a wave
    # arrives as an affinity ensemble — a required hostname-edge pair
    # of groups, a mutual anti-affinity pair, or a bounded hostname
    # spread group, drawn from the seeded world stream with per-wave
    # unique selector labels (edges never reach across waves).  Arms
    # the affinity-satisfied invariant; with shard_count > 0 also the
    # components-never-split invariant.
    affinity_wave_rate: float = 0.0
    # fixture knob: solve through an affinity-BLIND wrapper (terms
    # stripped from the solver's view while the cluster keeps them) —
    # proves affinity-satisfied fires when placement really ignores
    # the edges
    break_affinity: bool = False
    # serving plane (karpenter_tpu/serving): shadow-run a persistent
    # device-resident ServingLoop through every pump beat — the pending
    # window encodes, delta-streams through the input ring (depth-1
    # deferred fetch so every D2H overlaps the next kick) — under the
    # no-window-lost-serving and ring-converges invariants
    serving: bool = False
    # fixture knob: corrupt one host-mirror word after every ring kick
    # (the device state and replay oracle stay honest) — proves
    # ring-converges fires when the mirror discipline really breaks
    break_ring: bool = False
    # device-fault plane (karpenter_tpu/faulttol): kind -> per-dispatch
    # probability for the deterministic FaultyDeviceInjector installed
    # at the device_guard seam (kinds: hang, error, oom, corrupt).
    # Non-empty arms the no-window-lost + health-converges invariants.
    device_fault_rates: dict[str, float] = field(default_factory=dict)
    # global live-instance cap imposed on the fake cloud for the chaos
    # window (0 = unlimited); lifts at quiesce.  Demand past the cap is
    # genuine overload: creates fail with quota_exceeded and pending
    # pods can only move via preemption onto existing capacity.
    instance_quota: int = 0
    # harness controllers skipped by name (fixture profiles use this to
    # deliberately break an invariant)
    disable_controllers: tuple[str, ...] = ()
    fixture: bool = False                # excluded from the default matrix

    def rate_for(self, method: str) -> float:
        return self.error_rates.get(method, self.error_rates.get("*", 0.0))

    def latency_for(self, method: str) -> tuple[float, float] | None:
        return self.latency.get(method, self.latency.get("*"))


def _profiles(*profiles: ChaosProfile) -> dict[str, ChaosProfile]:
    return {p.name: p for p in profiles}


# The scenario matrix (`make chaos` runs every non-fixture profile).
PROFILES: dict[str, ChaosProfile] = _profiles(
    ChaosProfile(
        name="calm",
        description="no faults — the control run proving the harness "
                    "itself holds every invariant"),
    ChaosProfile(
        name="flaky-api",
        description="background 5xx/timeout noise + jittered latency on "
                    "every cloud call",
        error_rates={"*": 0.08, "create_instance": 0.15},
        latency={"*": (0.05, 2.0)}),
    ChaosProfile(
        name="rate-limited",
        description="429 storms with Retry-After — exercises the "
                    "honor-Retry-After + decorrelated-jitter retry stack",
        error_rates={"*": 0.20},
        error_kinds=(("rate_limited", 8.0), ("unavailable", 1.0)),
        latency={"*": (0.01, 0.5)}),
    ChaosProfile(
        name="partial-lists",
        description="list responses silently truncated + timeouts — "
                    "controllers must never actuate destructively off an "
                    "incomplete list",
        partial_list_rate=0.30,
        error_rates={"*": 0.05},
        error_kinds=(("timeout", 3.0), ("unavailable", 1.0))),
    ChaosProfile(
        name="leaky-creates",
        description="mid-create failures leak tagged instances with no "
                    "claim — the orphan-cleanup/GC path must reap them",
        create_leak_rate=0.35,
        error_rates={"create_instance": 0.10}),
    ChaosProfile(
        name="spot-storm",
        description="spot preemption storms + metadata health "
                    "degradation — interruption/preemption controllers "
                    "must black out offerings and replace capacity",
        preempt_storm_rate=0.50, preempt_storm_frac=0.60,
        degrade_rate=0.30),
    ChaosProfile(
        name="capacity-crunch",
        description="rolling (type, zone) capacity blackouts — create "
                    "failures must feed UnavailableOfferings and the "
                    "solver must route around them",
        capacity_blackout_rate=0.45, capacity_blackout_rounds=3,
        error_rates={"create_instance": 0.05}),
    ChaosProfile(
        name="solver-degraded",
        description="solver backend failures mid-provision — the "
                    "degraded greedy fallback must complete the cycle",
        solver_failure_rate=0.40,
        error_rates={"*": 0.04}),
    ChaosProfile(
        name="overload",
        description="instance quota far below demand + capacity "
                    "blackouts + spot storms under a mixed-priority "
                    "backlog — the preemption plane must move "
                    "high-priority pods onto existing capacity with "
                    "zero priority inversion, and every preempted pod "
                    "must re-resolve once the quota lifts",
        instance_quota=10,
        pod_priorities=(0, 0, 0, 100, 100, 1000),
        pod_waves=6, pods_per_wave=(10, 30),
        capacity_blackout_rate=0.40, capacity_blackout_rounds=3,
        preempt_storm_rate=0.30, preempt_storm_frac=0.40,
        error_rates={"create_instance": 0.10}),
    ChaosProfile(
        name="gang",
        description="mixed gang/singleton backlog (staggered and starved "
                    "gangs included) + capacity blackouts + spot storms — "
                    "gangs must place atomically (no partial gang ever "
                    "nominated) and every gang must resolve or be "
                    "deadline-released to per-pod scheduling",
        gang_wave_rate=0.6, gang_sizes=(4, 6, 8),
        gang_slice_shapes=("", "2x2", "2x2x2"),
        gang_stagger_rate=0.35, gang_starve_rate=0.25,
        pod_waves=6, pods_per_wave=(4, 12),
        capacity_blackout_rate=0.35, capacity_blackout_rounds=3,
        preempt_storm_rate=0.25, preempt_storm_frac=0.40,
        error_rates={"create_instance": 0.10}),
    ChaosProfile(
        name="oversubscribe",
        description="high-variance usage distributions packed under a "
                    "chance-constraint overcommit bound + spot storms — "
                    "the measured node-overload frequency must stay at "
                    "or under epsilon, and the spot risk the solver "
                    "prices must match the ledger's observed "
                    "interruption history exactly",
        pod_usage_mean_frac=0.5, pod_usage_cv=(0.1, 0.2, 0.3),
        overcommit_eps=0.05,
        pod_waves=6, pods_per_wave=(10, 30),
        preempt_storm_rate=0.45, preempt_storm_frac=0.5,
        degrade_rate=0.20,
        error_rates={"create_instance": 0.08},
        # the preemption plane accounts node residuals by REQUEST;
        # against a deliberately-overcommitted fleet its slack filler
        # would fight the stochastic packer every round — the
        # oversubscription class owns density here
        disable_controllers=("preemption",)),
    ChaosProfile(
        name="shard-skew",
        description="hash-hot pod keys concentrating load on one shard "
                    "of the sharded continuous-solve service, under "
                    "spot storms — the per-shard device-resident "
                    "tensors must stay word-identical to a "
                    "ClusterState rebuild and the rebalance collective "
                    "must provably drain the skew (shards-converge "
                    "invariant)",
        shard_count=2, shard_hot_rate=0.75,
        pod_waves=6, pods_per_wave=(10, 24),
        preempt_storm_rate=0.35, preempt_storm_frac=0.45,
        error_rates={"create_instance": 0.08}),
    ChaosProfile(
        name="device-fault",
        description="hung/faulted/OOM/corrupt device dispatches injected "
                    "at the device_guard seam while the sharded plane "
                    "and resident store keep solving — every window "
                    "must complete via deadline-bounded host failover "
                    "(no-window-lost), quarantined devices must recover "
                    "through probation by quiesce (health-converges), "
                    "and resident-state-fresh / shards-converge must "
                    "hold throughout",
        device_fault_rates={"hang": 0.05, "error": 0.05, "oom": 0.03,
                            "corrupt": 0.03},
        shard_count=2,
        pod_waves=6, pods_per_wave=(8, 24),
        error_rates={"create_instance": 0.05}),
    ChaosProfile(
        name="affinity",
        description="pod-to-pod (anti-)affinity edges and bounded "
                    "hostname spread riding most waves, under spot "
                    "storms and capacity blackouts, with the sharded "
                    "plane co-routing affinity components — every "
                    "placed edge must re-verify from ClusterState "
                    "ground truth (affinity-satisfied) and the shard "
                    "ownership map must never split a component "
                    "(components-never-split)",
        affinity_wave_rate=0.7,
        shard_count=2,
        pod_waves=6, pods_per_wave=(6, 16),
        preempt_storm_rate=0.30, preempt_storm_frac=0.40,
        capacity_blackout_rate=0.30, capacity_blackout_rounds=3,
        error_rates={"create_instance": 0.08},
        # the preemption plane's slack filler nominates pending pods
        # onto EXISTING claims with no affinity gates (the documented
        # carve-out the interaction tests pin) — against this profile's
        # anti-affinity workload it would co-locate antagonists across
        # windows, so the affinity class owns placement here
        disable_controllers=("preemption",)),
    ChaosProfile(
        name="fragmentation",
        description="scattered accelerator singletons + parked slice "
                    "gangs with the migration-first repack plane live — "
                    "torus defragmentation must reopen contiguous slices "
                    "(no gang starves to deadline release while aggregate "
                    "chips exist) and every executed migration plan must "
                    "re-validate against ground truth",
        repack=True,
        pod_gpu=(1,),
        # pin the scatter to the 8-chip-torus rung: a 2x2x2 gang needs
        # the WHOLE torus, so any singleton chip on a node strands it
        pod_node_selector={"node.kubernetes.io/instance-type":
                           "gx3-64x512"},
        gang_wave_rate=0.45, gang_sizes=(4,),
        gang_slice_shapes=("2x2x2",),
        gang_stagger_rate=0.0, gang_starve_rate=0.0,
        pod_waves=6, pods_per_wave=(3, 4),
        # a live-instance cap keeps the gang from simply creating a
        # fresh torus: it must wait for defrag to reopen one (lifts at
        # quiesce, like the overload profile); the preemption plane's
        # slack-filler is off so singleton waves stay SCATTERED across
        # partially-filled tori instead of backfilling tight
        instance_quota=4,
        disable_controllers=("preemption",),
        error_rates={"create_instance": 0.05}),
    ChaosProfile(
        name="serving-storm",
        description="sustained churn windows streaming through the "
                    "persistent device-resident serving loop while "
                    "capacity blackouts bump catalog generations and "
                    "device faults hit mid-kick — every submitted window "
                    "must come back as a plan via the ring, the classic "
                    "fallback, or host failover "
                    "(no-window-lost-serving), and the ring state must "
                    "stay word-identical to its host mirror and replay "
                    "oracle (ring-converges)",
        serving=True,
        pod_waves=6, pods_per_wave=(8, 24),
        capacity_blackout_rate=0.35, capacity_blackout_rounds=3,
        preempt_storm_rate=0.30, preempt_storm_frac=0.40,
        device_fault_rates={"hang": 0.04, "error": 0.04, "corrupt": 0.03},
        error_rates={"create_instance": 0.08}),
)

# Fixture profiles: deliberately broken worlds the test suite uses to
# prove a real violation FAILS the run (with a replay command).
FIXTURE_PROFILES: dict[str, ChaosProfile] = _profiles(
    ChaosProfile(
        name="broken-fixture",
        description="leaky creates with GC + orphan cleanup disabled — "
                    "the no-stale-orphan invariant MUST fire",
        create_leak_rate=0.50,
        disable_controllers=("nodeclaim.garbagecollection",
                             "node.orphancleanup"),
        fixture=True),
    ChaosProfile(
        name="broken-affinity-fixture",
        description="affinity waves solved through an affinity-BLIND "
                    "applier (terms stripped from the solver's view) — "
                    "the affinity-satisfied invariant MUST fire",
        affinity_wave_rate=1.0,
        break_affinity=True,
        pod_waves=4, pods_per_wave=(6, 12),
        disable_controllers=("preemption",),
        fixture=True),
    ChaosProfile(
        name="broken-ring",
        description="serving windows kicked through a ring whose host "
                    "mirror is corrupted after every dispatch — the "
                    "ring-converges invariant MUST fire",
        serving=True,
        break_ring=True,
        pod_waves=4, pods_per_wave=(8, 16),
        fixture=True),
)


def get_profile(name: str) -> ChaosProfile:
    p = PROFILES.get(name) or FIXTURE_PROFILES.get(name)
    if p is None:
        known = sorted(PROFILES) + sorted(FIXTURE_PROFILES)
        raise KeyError(f"unknown chaos profile {name!r}; known: {known}")
    return p
