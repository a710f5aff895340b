"""Invariant catalog: what must stay true no matter what chaos does.

Checked between ``ControllerManager.sync()`` rounds against GROUND TRUTH
(the unwrapped fake cloud + cluster state), never through the chaos
proxy — an invariant checker that can be lied to proves nothing.

Round invariants (hold continuously, modulo a convergence grace sized in
scenario rounds):

- ``no-stale-orphan``: no Karpenter-tagged instance older than
  ``orphan_grace`` without a claim or node tracking it (leaked creates
  must be reaped by GC / orphan cleanup);
- ``no-stuck-claim``: no live claim still uninitialized past
  ``stuck_claim_grace`` (registration or GC replacement must act);
- ``solver-plan-valid``: every plan that reached actuation passed the
  independent ``solver/validate.py`` oracle.

Final invariants (eventual, checked after the quiesce phase):

- ``blackouts-expire``: every UnavailableOfferings entry expired once
  its TTL elapsed on the virtual clock;
- ``pods-resolve``: every pending pod is bound, or provably unplaceable
  (its requests fit no offering in the catalog).

Preemption-plane invariants (armed when the harness runs a
PreemptionController):

- ``no-priority-inversion`` (round): no executed eviction's victim had
  priority >= its beneficiary's — checked against the controller's
  ground-truth eviction log, drained per round;
- ``preempted-pods-resolve`` (final): every pod the preemption plane
  ever evicted is bound again after quiesce (or provably unplaceable) —
  eviction may delay a low-priority pod, never strand it.

Gang-plane invariants (armed when the harness runs a
GangAdmissionController):

- ``no-partial-gang-placed`` (round): every executed gang placement
  carried the gang's FULL pending membership (>= min_member, no
  duplicates) — checked against the controller's ground-truth placement
  log, drained per round;
- ``gangs-resolve-or-release`` (final): after quiesce no pod still
  carries a gang and sits unbound — every gang either placed whole, or
  was deadline-released to per-pod scheduling (whose members the
  ordinary pods-resolve invariant then covers), or is provably
  unplaceable (no offering fits a member / no torus hosts the slice).

Affinity-plane invariants (armed by ``affinity_wave_rate`` profiles,
karpenter_tpu/affinity):

- ``affinity-satisfied`` (round): every placed (anti-)affinity edge and
  bounded hostname spread re-verifies from ClusterState ground truth —
  anti-affinity pairs never co-located, required edges have a matching
  pod in scope, per-node matching counts stay under the bound;
- ``components-never-split`` (round, with a sharded service): the shard
  ownership map keeps every affinity-connected component on one shard
  (re-derived from raw pod labels by ``sharded/validate.py``, never
  from the router's own index).

Serving-plane invariants (armed by ``serving`` profiles,
karpenter_tpu/serving):

- ``no-window-lost-serving`` (round): every window the pump submitted
  to the ServingLoop came back as a plan — via the ring, the classic
  fallback, or host failover — the loop's routing ledger balances
  exactly (ring + classic == windows), and at most the one pipelined
  window is ever unfetched;
- ``ring-converges`` (round): the loop's device-resident state, its
  host mirror, and the independent RingOracle replay of every admitted
  slot agree word-for-word, under the current catalog generation
  (delegated to ``serving/validate.ring_state_violations``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from karpenter_tpu_torch.apis.nodeclaim import parse_provider_id
from karpenter_tpu_torch.chaos.trace import EventTrace
from karpenter_tpu_torch.core.actuator import KARPENTER_TAGS


@dataclass(frozen=True)
class Violation:
    invariant: str
    detail: str

    def render(self) -> str:
        return f"[{self.invariant}] {self.detail}"


class InvariantChecker:
    def __init__(self, cluster, cloud, unavailable, *,
                 orphan_grace: float, stuck_claim_grace: float,
                 solver_violations: list[str] | None = None,
                 trace: EventTrace | None = None, preemption=None,
                 gang=None, resident=None, repack=None,
                 explain_violations: list[str] | None = None,
                 stochastic=None, sharded=None, faulttol=None,
                 serving=None, affinity: bool = False):
        self.cluster = cluster
        self.cloud = cloud              # ground truth: the UNWRAPPED fake
        self.unavailable = unavailable
        self.orphan_grace = orphan_grace
        self.stuck_claim_grace = stuck_claim_grace
        # shared with the harness's ValidatingSolver; drained per check
        self.solver_violations = solver_violations \
            if solver_violations is not None else []
        # explain-consistency contradictions (karpenter_tpu/explain):
        # every unplaced pod's reason is re-derived from the request and
        # checked against ground truth — a pod blamed on availability
        # while a feasible offering sits open is a violation
        self.explain_violations = explain_violations \
            if explain_violations is not None else []
        self.trace = trace
        # the harness's PreemptionController (or None): its eviction_log
        # / preempted_keys are the preemption invariants' ground truth
        self.preemption = preemption
        # the harness's GangAdmissionController (or None): its
        # placement_log / released set back the gang invariants
        self.gang = gang
        # resident-state probe (or None): exposes .store (the harness's
        # ResidentStore), .window_pods() and .catalog() — the inputs the
        # harness tracked, re-listed from ClusterState at check time so
        # the rebuild below is ground truth, not an echo of the store
        self.resident = resident
        # repack probe (or None): .controller is the harness's
        # DisruptionController (repack_log / repack_violations are the
        # executed-migration-plan ground truth, drained per round),
        # .catalog() re-derives target capacity and torus geometry
        self.repack = repack
        # stochastic probe (or None): the oversubscription profile's
        # epsilon bound + catalog/model getters — backs the
        # violation-rate-under-bound and risk-model-consistent
        # invariants (karpenter_tpu/stochastic)
        self.stochastic = stochastic
        # sharded probe (or None): the shard-skew profile's shadow
        # service + window/catalog getters — backs the shards-converge
        # invariant (karpenter_tpu/sharded)
        self.sharded = sharded
        # faulttol probe (or None): the device-fault profile's health
        # board, injector and window-accounting ground truth — backs the
        # no-window-lost (round) and health-converges (final) invariants
        # (karpenter_tpu/faulttol)
        self.faulttol = faulttol
        # serving probe (or None): the serving-storm profile's
        # ServingLoop + submit/receive ledgers — backs the
        # no-window-lost-serving and ring-converges invariants
        # (karpenter_tpu/serving)
        self.serving = serving
        # affinity arming flag: the profile injects affinity ensembles,
        # so every bound pod's edges re-verify from ClusterState each
        # round (karpenter_tpu/affinity)
        self.affinity = affinity

    # -- round invariants ----------------------------------------------------

    def check_round(self) -> list[Violation]:
        out: list[Violation] = []
        out.extend(self._no_stale_orphans())
        out.extend(self._no_stuck_claims())
        out.extend(self._solver_plans_valid())
        out.extend(self._explain_consistent())
        out.extend(self._no_priority_inversion())
        out.extend(self._no_partial_gang_placed())
        out.extend(self._resident_state_fresh())
        out.extend(self._repack_plans_valid())
        out.extend(self._risk_model_consistent())
        out.extend(self._shards_converge())
        out.extend(self._no_window_lost())
        out.extend(self._no_window_lost_serving())
        out.extend(self._ring_converges())
        out.extend(self._affinity_satisfied())
        out.extend(self._components_never_split())
        if self.trace is not None:
            self.trace.add("invariants", phase="round", violations=len(out),
                           kinds=sorted({v.invariant for v in out}))
        return out

    def _tracked_instance_ids(self) -> set:
        ids = set()
        for claim in self.cluster.nodeclaims():
            parsed = parse_provider_id(claim.provider_id)
            if parsed:
                ids.add(parsed[1])
        for node in self.cluster.nodes():
            parsed = parse_provider_id(node.provider_id)
            if parsed:
                ids.add(parsed[1])
        return ids

    def _no_stale_orphans(self) -> list[Violation]:
        now = time.time()
        tracked = self._tracked_instance_ids()
        out = []
        for inst in self.cloud.list_instances():
            if not all(inst.tags.get(k) == v for k, v in KARPENTER_TAGS.items()):
                continue   # unmanaged: never ours to track (or reap)
            age = now - inst.created_at
            if inst.id not in tracked and age > self.orphan_grace:
                out.append(Violation(
                    "no-stale-orphan",
                    f"tagged instance {inst.id} ({inst.profile}/{inst.zone}) "
                    f"untracked for {age:.0f}s > {self.orphan_grace:.0f}s"))
        return out

    def _no_stuck_claims(self) -> list[Violation]:
        now = time.time()
        out = []
        for claim in self.cluster.nodeclaims():
            if claim.deleted or not claim.launched or claim.initialized:
                continue
            age = now - claim.created_at
            if age > self.stuck_claim_grace:
                out.append(Violation(
                    "no-stuck-claim",
                    f"claim {claim.name} uninitialized for {age:.0f}s "
                    f"> {self.stuck_claim_grace:.0f}s"))
        return out

    def _solver_plans_valid(self) -> list[Violation]:
        out = [Violation("solver-plan-valid", v)
               for v in self.solver_violations]
        self.solver_violations.clear()
        return out

    def _explain_consistent(self) -> list[Violation]:
        out = [Violation("explain-consistent", v)
               for v in self.explain_violations]
        self.explain_violations.clear()
        return out

    def _no_priority_inversion(self) -> list[Violation]:
        """Every executed eviction must have served a STRICTLY higher
        priority beneficiary — drained from the controller's log so a
        violation names the exact victim."""
        if self.preemption is None:
            return []
        out = []
        for rec in self.preemption.eviction_log:
            if rec.victim_priority >= rec.beneficiary_priority:
                out.append(Violation(
                    "no-priority-inversion",
                    f"pod {rec.pod_key} (priority {rec.victim_priority}) "
                    f"evicted from {rec.claim_name} for priority "
                    f"{rec.beneficiary_priority} pod {rec.beneficiary}"))
        self.preemption.eviction_log.clear()
        return out

    def _no_partial_gang_placed(self) -> list[Violation]:
        """Every executed gang placement must have carried the gang's
        full pending membership, at or above min_member — drained from
        the controller's log so a violation names the exact gang."""
        if self.gang is None:
            return []
        out = []
        for rec in self.gang.placement_log:
            members = set(rec.members)
            if len(members) != len(rec.members):
                out.append(Violation(
                    "no-partial-gang-placed",
                    f"gang {rec.gang} placement on {rec.claim_name} "
                    f"repeats members"))
            if len(members) < rec.total_members \
                    or len(members) < rec.min_member:
                out.append(Violation(
                    "no-partial-gang-placed",
                    f"gang {rec.gang} placed {len(members)}/"
                    f"{rec.total_members} members (min_member "
                    f"{rec.min_member}) on {rec.claim_name}"))
        self.gang.placement_log.clear()
        return out

    def _resident_state_fresh(self) -> list[Violation]:
        """The resident store's mirror AND its device-resident tensors
        must equal a from-scratch rebuild of the tracked window from
        ClusterState — stale device state (a missed invalidation, a
        mis-applied delta) is exactly the failure mode the
        generation-tracked store exists to prevent
        (docs/design/resident.md 'parity contract')."""
        probe = self.resident
        if probe is None:
            return []
        snap = probe.store.snapshot_state()
        if snap is None:
            return []      # no window tracked yet
        catalog = probe.catalog()
        if catalog is None:
            return []
        import numpy as np

        from karpenter_tpu_torch.resident.delta import pack_window
        from karpenter_tpu_torch.solver.encode import encode

        problem = encode(probe.window_pods(), catalog)
        fresh, shape = pack_window(problem)
        fresh = fresh.reshape(-1)
        out: list[Violation] = []
        if snap["key"] != (catalog.uid,) + shape:
            return [Violation(
                "resident-state-fresh",
                f"tracked state keyed {snap['key']} but the current "
                f"window lowers to {(catalog.uid,) + shape}")]
        gen = (catalog.generation, catalog.availability_generation)
        if snap["generation"] != gen:
            out.append(Violation(
                "resident-state-fresh",
                f"resident generation {snap['generation']} != catalog "
                f"generation {gen} (missed invalidation)"))
        if snap["mirror"].shape != fresh.shape \
                or not np.array_equal(snap["mirror"], fresh):
            diff = int(np.count_nonzero(snap["mirror"] != fresh)) \
                if snap["mirror"].shape == fresh.shape else -1
            out.append(Violation(
                "resident-state-fresh",
                f"host mirror diverged from a fresh ClusterState "
                f"rebuild ({diff} words differ)"))
        dev = np.asarray(snap["device"]).reshape(-1)
        if dev.shape != fresh.shape or not np.array_equal(dev, fresh):
            diff = int(np.count_nonzero(dev != fresh)) \
                if dev.shape == fresh.shape else -1
            out.append(Violation(
                "resident-state-fresh",
                f"device-resident tensors diverged from a fresh "
                f"ClusterState rebuild ({diff} words differ)"))
        return out

    def _repack_plans_valid(self) -> list[Violation]:
        """Every EXECUTED migration plan re-derives as valid from ground
        truth: choke-point validator errors surface (an invalid plan was
        produced, even though it was never actuated), no pod was
        dropped (drained claims are deleted and nothing is still homed
        on them; every migrated pod still exists), per-target capacity
        re-derived from catalog allocatable is respected, and each
        claimed slice reopening re-enumerates from the type's torus
        geometry — fits the vacated occupancy, not the occupied one.
        Drained per round, like the preemption/gang logs."""
        if self.repack is None:
            return []
        ctrl = self.repack.controller
        out = [Violation("repack-plan-valid", v)
               for v in ctrl.repack_violations]
        ctrl.repack_violations.clear()
        catalog = self.repack.catalog()
        for rec in ctrl.repack_log:
            out.extend(self._check_repack_record(rec, catalog))
        ctrl.repack_log.clear()
        return out

    def _check_repack_record(self, rec, catalog) -> list[Violation]:
        from karpenter_tpu_torch.gang.topology import enumerate_placements

        out: list[Violation] = []
        drained = set(rec.drained)
        drained_nodes = set()
        for name in rec.drained:
            claim = self.cluster.get_nodeclaim(name)
            if claim is None:
                continue
            if not claim.deleted:
                out.append(Violation(
                    "repack-plan-valid",
                    f"drained claim {name} still live after actuation"))
            if claim.node_name:
                drained_nodes.add(claim.node_name)
        seen: set[str] = set()
        targets: dict[str, int] = {}
        for pod, src, dst in rec.migrations:
            if pod in seen:
                out.append(Violation(
                    "repack-plan-valid", f"pod {pod} migrated twice in "
                    f"one plan"))
            seen.add(pod)
            if src == dst:
                out.append(Violation(
                    "repack-plan-valid",
                    f"pod {pod} migrated onto its own node {src}"))
            if dst in drained:
                out.append(Violation(
                    "repack-plan-valid",
                    f"pod {pod} migrated onto drained claim {dst}"))
            if self.cluster.get("pods", pod) is None:
                out.append(Violation(
                    "repack-plan-valid",
                    f"migrated pod {pod} vanished (dropped)"))
            targets[dst] = targets.get(dst, 0) + 1
        # no pod dropped: nothing still homed on a drained claim/node
        for p in self.cluster.list("pods"):
            homes = {p.bound_node, p.nominated_node}
            if homes & (drained | drained_nodes):
                from karpenter_tpu_torch.apis.pod import pod_key

                out.append(Violation(
                    "repack-plan-valid",
                    f"pod {pod_key(p.spec)} still homed on a drained "
                    f"claim ({p.bound_node or p.nominated_node})"))
        # capacity respected: re-derive each migration target's residual
        # from catalog allocatable minus its CURRENT occupants
        if catalog is not None:
            from karpenter_tpu_torch.preempt.encode import (
                _pod_req_vec, claim_pods, occupancy_index,
            )

            idx = occupancy_index(self.cluster)
            for name in sorted(targets):
                claim = self.cluster.get_nodeclaim(name)
                if claim is None or claim.deleted:
                    continue
                o = catalog.find_offering(claim.instance_type, claim.zone,
                                          claim.capacity_type)
                if o is None:
                    continue
                resid = catalog.offering_alloc()[o].astype("int64").copy()
                for p in claim_pods(self.cluster, claim, index=idx):
                    resid -= _pod_req_vec(p.spec)
                if (resid < 0).any():
                    out.append(Violation(
                        "repack-plan-valid",
                        f"migration target {name} over capacity after "
                        f"actuation (residual {resid.tolist()})"))
        # claimed slices actually reopened: re-enumerate the geometry
        # from the type's torus dims (independent of every planner path)
        for claim_name, offering, shape, pre, post in rec.reopened:
            if claim_name in drained:
                out.append(Violation(
                    "repack-plan-valid",
                    f"slice {shape} claimed reopened on DRAINED claim "
                    f"{claim_name}"))
                continue
            if catalog is None or offering >= catalog.num_offerings:
                continue
            t = int(catalog.off_type[offering])
            torus = tuple(catalog.type_torus[t]) \
                if t < len(catalog.type_torus) else ()
            fits_pre = fits_post = False
            for mask in enumerate_placements(torus, tuple(shape)):
                if (mask & pre) == 0:
                    fits_pre = True
                if (mask & post) == 0:
                    fits_post = True
            if fits_pre:
                out.append(Violation(
                    "repack-plan-valid",
                    f"slice {shape} on {claim_name} already fit before "
                    f"the defrag move (nothing reopened)"))
            if not fits_post:
                out.append(Violation(
                    "repack-plan-valid",
                    f"slice {shape} on {claim_name} does not fit the "
                    f"vacated torus (claimed reopening is false)"))
        return out

    def _shards_converge(self) -> list[Violation]:
        """Sharded-plane ground truth (karpenter_tpu/sharded):

        - the routed partition is a disjoint cover (every pending pod
          on exactly one shard, no split signature group);
        - the per-shard device-resident tensors AND the host mirror
          equal a from-scratch rebuild of the window from ClusterState,
          word for word (the stacked generalization of
          resident-state-fresh);
        - the last rebalance decision re-derives exactly from its
          pressure matrix via the independent numpy oracle, and its
          migrations actually landed on the receiver;
        - skew provably drains: a collective that keeps asking for
          migrations while the donor owns splittable groups and nothing
          moves for 3 consecutive rounds is stuck, not converging.
        """
        probe = self.sharded
        if probe is None:
            return []
        catalog = probe.catalog()
        if catalog is None:
            return []
        from karpenter_tpu_torch.sharded.validate import (
            partition_violations, rebalance_violations, state_violations,
        )

        svc = probe.service
        pods = probe.window_pods()
        out = [Violation("shards-converge", v)
               for v in partition_violations(svc, pods)]
        out.extend(Violation("shards-converge", v)
                   for v in state_violations(svc, pods, catalog))
        out.extend(Violation("shards-converge", v)
                   for v in rebalance_violations(svc, svc.last_decision))
        dec = svc.last_decision
        if dec is not None and dec.amount > 0 \
                and dec.donor != dec.receiver and not dec.moved_keys \
                and int(dec.pressure[dec.donor, 1]) > 1:
            probe.stuck_rounds += 1
            if probe.stuck_rounds >= 3:
                out.append(Violation(
                    "shards-converge",
                    f"rebalance stuck: shard {dec.donor} holds skew "
                    f"{dec.skew} across {probe.stuck_rounds} rounds "
                    f"with {int(dec.pressure[dec.donor, 1])} splittable "
                    f"groups and zero migrations applied"))
        else:
            probe.stuck_rounds = 0
        return out

    def _risk_model_consistent(self) -> list[Violation]:
        """The rates the solver PRICES must equal the rates the ledger
        OBSERVED — exactly, not within tolerance: both sides are
        integer-count ratios over the same history, so any difference
        is a stale model or a pricing bug, never noise.  Checked two
        ways: the harness's model vs a fresh ledger rebuild, and the
        catalog's off_risk column vs the column that fresh model
        implies."""
        probe = self.stochastic
        if probe is None:
            return []
        model = probe.model()
        if model is None:
            return []      # no pump has priced yet
        import numpy as np

        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.stochastic.risk import SpotRiskModel

        fresh = SpotRiskModel.from_ledger(obs.get_ledger())
        out: list[Violation] = []
        if fresh.counts() != model.counts():
            out.append(Violation(
                "risk-model-consistent",
                f"priced model counts {model.counts()} != ledger-observed "
                f"counts {fresh.counts()}"))
        catalog = probe.catalog()
        if catalog is not None:
            want = fresh.risk_column(catalog)
            got = getattr(catalog, "off_risk", None)
            if got is None:
                if want.any():
                    out.append(Violation(
                        "risk-model-consistent",
                        "ledger holds interruption history but the "
                        "catalog prices no spot risk"))
            elif not np.array_equal(got, want):
                diff = int(np.count_nonzero(got != want))
                out.append(Violation(
                    "risk-model-consistent",
                    f"catalog off_risk diverges from the ledger-derived "
                    f"column ({diff} offerings differ)"))
        return out

    def _no_window_lost(self) -> list[Violation]:
        """Every provisioning beat's window completed — on the device or
        via the bit-identical host failover — no matter what the device
        injector did.  Ground truth is the harness's own pump count
        (``probe.windows_expected``) against the resident store's and
        sharded service's window accounting: a lost window (a dispatch
        hang that stalled the loop, a fault that escaped the fallback
        ladder) shows up as a beat that never accounted."""
        probe = self.faulttol
        if probe is None or probe.windows_expected == 0:
            return []
        out = []
        if probe.resident is not None \
                and probe.resident.windows != probe.windows_expected:
            out.append(Violation(
                "no-window-lost",
                f"resident store accounted {probe.resident.windows} "
                f"windows over {probe.windows_expected} beats "
                f"(injector faults: "
                f"{probe.injector.injected if probe.injector else 0})"))
        if probe.sharded is not None \
                and probe.sharded.windows != probe.windows_expected:
            out.append(Violation(
                "no-window-lost",
                f"sharded service accounted {probe.sharded.windows} "
                f"windows over {probe.windows_expected} beats "
                f"(degraded: "
                f"{getattr(probe.sharded, 'degraded_windows', 0)})"))
        return out

    def _no_window_lost_serving(self) -> list[Violation]:
        """Every window the pump submitted to the serving loop came
        back as a plan — ring, classic fallback, or host failover —
        no matter what the device injector did.  Ground truth is the
        harness's own submit/receive ledgers (the probe) against the
        loop's routing counters: a lost window shows up as a submit
        that never accounted, a routing ledger that doesn't balance,
        or a fetch backlog past the one pipelined window."""
        probe = self.serving
        if probe is None or probe.windows_expected == 0:
            return []
        loop = probe.loop
        out = []
        if loop.windows != probe.windows_expected:
            out.append(Violation(
                "no-window-lost-serving",
                f"serving loop accounted {loop.windows} windows over "
                f"{probe.windows_expected} submitted beats"))
        if loop.ring_windows + loop.classic_windows != loop.windows:
            out.append(Violation(
                "no-window-lost-serving",
                f"routing ledger leaks: ring {loop.ring_windows} + "
                f"classic {loop.classic_windows} != "
                f"windows {loop.windows}"))
        backlog = probe.windows_expected - probe.plans_received
        if backlog > 1:
            out.append(Violation(
                "no-window-lost-serving",
                f"{backlog} submitted windows never fetched (pipelining "
                f"depth is 1 — at most one may be in flight)"))
        return out

    def _ring_converges(self) -> list[Violation]:
        """The serving loop's device-resident state, its host mirror,
        and the independent RingOracle replay of every admitted slot
        agree word-for-word, under the current catalog generation —
        delegated to the plane's own independent validator
        (``serving/validate.ring_state_violations``), same pattern as
        shards-converge."""
        probe = self.serving
        if probe is None:
            return []
        from karpenter_tpu_torch.serving.validate import ring_state_violations

        return [Violation("ring-converges", v)
                for v in ring_state_violations(probe.loop,
                                               probe.catalog())]

    def _affinity_satisfied(self) -> list[Violation]:
        """Every placed (anti-)affinity edge and bounded hostname spread
        re-verified from ClusterState GROUND TRUTH — bound pods, their
        raw labels and terms, the claims' node/zone map — never through
        the solver's index or the plan's own claims.  Mirrors the
        plane's arming rules (docs/design/affinity.md): self-anti
        hostname terms, anti terms matching nobody, and ScheduleAnyway /
        zone-scope spread stay legacy and are not re-checked here."""
        if not self.affinity:
            return []
        from karpenter_tpu_torch.apis.pod import HOSTNAME_TOPOLOGY_KEY, pod_key

        # canonical node id: a pod may be homed by claim name or node
        # name — fold claim names onto their node so one physical node
        # never reads as two
        canon: dict[str, str] = {}
        zone_of: dict[str, str] = {}
        for claim in self.cluster.nodeclaims():
            node = claim.node_name or claim.name
            canon[claim.name] = node
            if claim.zone:
                zone_of[node] = claim.zone
                zone_of[claim.name] = claim.zone
        by_node: dict[str, list] = {}
        for p in self.cluster.list("pods"):
            if p.bound_node:
                node = canon.get(p.bound_node, p.bound_node)
                by_node.setdefault(node, []).append(p.spec)
        by_zone: dict[str, list] = {}
        for node, specs in by_node.items():
            z = zone_of.get(node)
            if z:
                by_zone.setdefault(z, []).extend(specs)

        def matches(sel, spec) -> bool:
            lab = spec.labels_dict
            return all(lab.get(k) == v for k, v in sel)

        out: list[Violation] = []
        spreads: dict[tuple, int] = {}   # (selector|sig sentinel) -> skew
        for node in sorted(by_node):
            specs = by_node[node]
            for spec in specs:
                for t in spec.affinity:
                    host = t.topology_key == HOSTNAME_TOPOLOGY_KEY
                    if host and t.anti and matches(t.label_selector, spec):
                        continue       # legacy self-anti: per-node cap 1
                    scope = specs if host \
                        else by_zone.get(zone_of.get(node, ""), specs)
                    if t.anti:
                        sig = spec.signature_key()
                        hit = [q for q in scope
                               if q is not spec
                               and q.signature_key() != sig
                               and matches(t.label_selector, q)]
                        if hit:
                            out.append(Violation(
                                "affinity-satisfied",
                                f"pod {pod_key(spec)} co-located with "
                                f"anti-affinity match {pod_key(hit[0])} "
                                f"in {t.topology_key} scope of {node}"))
                    elif not any(matches(t.label_selector, q)
                                 for q in scope):
                        out.append(Violation(
                            "affinity-satisfied",
                            f"pod {pod_key(spec)} bound to {node} with "
                            f"no {t.topology_key}-scope pod matching its "
                            f"required selector {t.label_selector}"))
                for c in spec.topology_spread:
                    if c.topology_key != HOSTNAME_TOPOLOGY_KEY \
                            or c.when_unsatisfiable != "DoNotSchedule":
                        continue       # zone / soft spread: legacy scope
                    key = c.label_selector or ("#sig",
                                               spec.signature_key())
                    prev = spreads.get(key)
                    spreads[key] = c.max_skew if prev is None \
                        else min(prev, c.max_skew)
        for key, skew in sorted(spreads.items()):
            for node in sorted(by_node):
                if key and key[0] == "#sig":
                    n = sum(1 for q in by_node[node]
                            if q.signature_key() == key[1])
                else:
                    n = sum(1 for q in by_node[node] if matches(key, q))
                if n > skew:
                    out.append(Violation(
                        "affinity-satisfied",
                        f"node {node} holds {n} pods matching spread "
                        f"selector {key} (max_skew {skew})"))
        return out

    def _components_never_split(self) -> list[Violation]:
        """The shard ownership map keeps every affinity-connected
        component on one shard — checked by the independent
        ``sharded/validate.component_violations`` oracle (components
        re-derived from raw pod labels, never from the router's own
        index)."""
        if not self.affinity or self.sharded is None:
            return []
        from karpenter_tpu_torch.sharded.validate import component_violations

        return [Violation("components-never-split", v)
                for v in component_violations(self.sharded.service,
                                              self.sharded.window_pods())]

    # -- final (eventual) invariants -----------------------------------------

    def _health_converges(self) -> list[Violation]:
        """After quiesce (injector disarmed, probes succeeding), no
        device is still quarantined or stuck in probation: the
        quarantine -> probation -> probe -> healthy machine must have
        walked every faulted device back."""
        probe = self.faulttol
        if probe is None or probe.board is None:
            return []
        from karpenter_tpu_torch.faulttol import HEALTHY

        snap = probe.board.snapshot()
        out = []
        for device, d in sorted(snap.get("devices", {}).items()):
            if d["state"] != HEALTHY:
                out.append(Violation(
                    "health-converges",
                    f"device {device} still {d['state']} after quiesce "
                    f"(faults_in_window={d['faults_in_window']}, "
                    f"quarantines={d['quarantines']}, "
                    f"last_kind={d['last_kind']})"))
        return out

    def check_final(self, catalog=None) -> list[Violation]:
        out: list[Violation] = []
        stale = self.unavailable.unavailable_keys()
        if stale:
            out.append(Violation(
                "blackouts-expire",
                f"{len(stale)} offering blackouts survived the quiesce "
                f"window: {sorted(stale)[:3]}"))
        out.extend(self._pods_resolve(catalog))
        out.extend(self._preempted_pods_resolve(catalog))
        out.extend(self._gangs_resolve_or_release(catalog))
        out.extend(self._violation_rate_under_bound())
        out.extend(self._health_converges())
        if self.trace is not None:
            self.trace.add("invariants", phase="final", violations=len(out),
                           kinds=sorted({v.invariant for v in out}))
        return out

    def _violation_rate_under_bound(self) -> list[Violation]:
        """At quiesce, the EMPIRICAL node-overload frequency of the
        oversubscribed fleet — seeded usage draws from every bound
        pod's own distribution — must stay at or under the pool's
        epsilon (plus finite-sample slack).  This is the promise the
        chance constraint makes; measuring it against ground-truth
        placements (never the solver's arithmetic) is the whole point
        of the invariant."""
        probe = self.stochastic
        if probe is None:
            return []
        catalog = probe.catalog()
        if catalog is None:
            return []
        from karpenter_tpu_torch.preempt.encode import (
            claim_pods, occupancy_index,
        )
        from karpenter_tpu_torch.stochastic.validate import (
            measured_violation_rate, violation_bound,
        )

        idx = occupancy_index(self.cluster)
        nodes = []
        for claim in self.cluster.nodeclaims():
            if claim.deleted or not claim.registered:
                continue
            o = catalog.find_offering(claim.instance_type, claim.zone,
                                      claim.capacity_type)
            if o is None:
                continue
            pods = [p.spec for p in claim_pods(self.cluster, claim,
                                               index=idx)]
            if pods:
                nodes.append((pods, catalog.offering_alloc()[o]))
        rate, samples = measured_violation_rate(nodes, trials=256,
                                                seed=probe.seed)
        bound = violation_bound(probe.eps, samples)
        if rate > bound:
            return [Violation(
                "violation-rate-under-bound",
                f"measured node-overload rate {rate:.4f} over "
                f"{samples} samples exceeds epsilon {probe.eps:g} "
                f"(+sampling slack = {bound:.4f}) across "
                f"{len(nodes)} occupied nodes")]
        return []

    def _preempted_pods_resolve(self, catalog) -> list[Violation]:
        """A preemption may DELAY a low-priority pod; it must never
        strand one.  After quiesce every ever-evicted pod is bound again
        (anywhere) or provably unplaceable."""
        if self.preemption is None:
            return []
        out = []
        for key in sorted(self.preemption.preempted_keys):
            pending = self.cluster.get("pods", key)
            if pending is None or pending.bound_node:
                continue
            if catalog is not None and \
                    not self._placeable(pending.spec, catalog):
                continue
            out.append(Violation(
                "preempted-pods-resolve",
                f"pod {key} evicted by preemption and still unbound "
                f"after quiesce (nominated="
                f"{pending.nominated_node or '-'})"))
        return out

    def _gangs_resolve_or_release(self, catalog) -> list[Violation]:
        """A gang may be delayed, placed, or deadline-released — never
        parked forever.  After quiesce, any unbound pod still carrying a
        gang is a violation unless the gang is provably unplaceable
        (the deadline release strips the gang field, so released
        members are ordinary pods covered by pods-resolve)."""
        if self.gang is None:
            return []
        by_gang: dict[str, list] = {}
        for pending in self.cluster.pending_pods():
            if pending.spec.gang is not None and not pending.bound_node:
                by_gang.setdefault(pending.spec.gang.name,
                                   []).append(pending)
        out = []
        for name, members in by_gang.items():
            if catalog is not None \
                    and not self._gang_placeable(members, catalog):
                continue
            for pending in members:
                spec = pending.spec
                out.append(Violation(
                    "gangs-resolve-or-release",
                    f"pod {spec.namespace}/{spec.name} of gang {name} "
                    f"still unbound and unreleased after quiesce "
                    f"(nominated={pending.nominated_node or '-'})"))
        return out

    @staticmethod
    def _gang_placeable(members, catalog) -> bool:
        """Can this gang conceivably place WHOLE: the real gang encoder
        answers exactly — some offering must be label-compatible, host
        the slice shape's torus, AND fit the gang's TOTAL member demand
        on one empty node (a per-member under-approximation here would
        flag correct systems for gangs that genuinely cannot place)."""
        from karpenter_tpu_torch.gang.encode import encode_gangs

        problem = encode_gangs([p.spec for p in members], catalog)
        return bool(problem.num_gangs and problem.compat.any())

    def _pods_resolve(self, catalog) -> list[Violation]:
        out = []
        pending_all = [p for p in self.cluster.pending_pods()
                       if not p.bound_node]
        for pending in pending_all:
            if catalog is not None and not self._placeable(pending.spec, catalog):
                continue   # explicitly unplaceable: fits no offering
            if self._affinity_unplaceable(pending.spec, pending_all):
                # required edge with no in-window target: the affinity
                # plane's documented contract (docs/design/affinity.md)
                # arms such pods honestly unplaceable — edges resolve
                # WITHIN a solve window, never against already-bound
                # capacity (that join is the kube-scheduler's, not the
                # provisioner's)
                continue
            out.append(Violation(
                "pods-resolve",
                f"pod {pending.spec.namespace}/{pending.spec.name} still "
                f"unbound after quiesce (nominated="
                f"{pending.nominated_node or '-'})"))
        return out

    @staticmethod
    def _affinity_unplaceable(spec, pending_all) -> bool:
        """True when a REQUIRED affinity term arms with no pending
        target: the selector matches neither the pod's own labels nor
        any other pending unbound pod — the plane's honest-unplaceable
        verdict (``affinity_unsatisfied``), by the same arming rules the
        encoder applies."""
        if not spec.affinity:
            return False
        own = spec.labels_dict
        for t in spec.affinity:
            if t.anti:
                continue           # anti matching nothing is a no-op
            if all(own.get(k) == v for k, v in t.label_selector):
                continue           # self-satisfiable (or legacy zone pin)
            if not any(
                    all(q.spec.labels_dict.get(k) == v
                        for k, v in t.label_selector)
                    for q in pending_all if q.spec is not spec):
                return True
        return False

    @staticmethod
    def _placeable(pod, catalog) -> bool:
        req = pod.requests.as_tuple()
        alloc = catalog.offering_alloc()
        for o in range(catalog.num_offerings):
            if all(int(alloc[o, i]) >= req[i] for i in range(len(req))):
                return True
        return False
