"""Operator: full process wiring (the main() + pkg/operator equivalent;
port of ``karpenter_tpu/operator/operator.py``).

Mirrors the reference's startup chain (SURVEY.md §3.1): validate
credentials (operator.go:80-97, process-fatal on failure) -> build the
cloud client + shared ``UnavailableOfferings`` (operator.go:62-63) ->
provider factory -> CloudProvider facade -> register the controller fleet
(controllers.go:117-259, with the same env gates) -> start the manager and
the provisioning loop.

The operator runs on ``device``: ``"cuda"`` by default, resolved once at
construction (no card -> it raises before any thread starts), or
``"cpu"``, where every kernel runs its plain PyTorch version.  Every
consumer that takes a device gets this one: the provisioner's solver,
the disruption, preemption and gang controllers and the what-if
planning service.
"""

from __future__ import annotations


from karpenter_tpu_torch.catalog.instancetype import InstanceTypeProvider
from karpenter_tpu_torch.catalog.pricing import PricingProvider
from karpenter_tpu_torch.catalog.unavailable import UnavailableOfferings
from karpenter_tpu_torch.cloud.fake import FakeCloud
from karpenter_tpu_torch.cloud.loadbalancer import LoadBalancerProvider
from karpenter_tpu_torch.controllers import ControllerManager
from karpenter_tpu_torch.controllers.bootstrap import BootstrapTokenController
from karpenter_tpu_torch.controllers.disruption import DisruptionController
from karpenter_tpu_torch.controllers.faults import (
    InstanceTypeRefreshController, InterruptionController, OrphanCleanupController,
    PricingRefreshController, SpotPreemptionController,
)
from karpenter_tpu_torch.controllers.iks import PoolCleanupController
from karpenter_tpu_torch.controllers.loadbalancer import (
    LBMembershipSweeper, LoadBalancerController,
)
from karpenter_tpu_torch.controllers.nodeclaim import (
    GarbageCollectionController, NodeClaimTerminationController,
    RegistrationController, StartupTaintController, TaggingController,
)
from karpenter_tpu_torch.controllers.nodeclass import (
    AutoplacementController, NodeClassHashController, NodeClassStatusController,
    NodeClassTerminationController,
)
from karpenter_tpu_torch.core.actuator import Actuator
from karpenter_tpu_torch.core.circuitbreaker import CircuitBreakerManager
from karpenter_tpu_torch.core.cloudprovider import CloudProvider
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.core.factory import ProviderFactory
from karpenter_tpu_torch.core.provisioner import Provisioner, ProvisionerOptions
from karpenter_tpu_torch.core.workerpool import WorkerPoolActuator
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.operator.credentials import (
    CredentialStore, EnvCredentialProvider, StaticCredentialProvider,
)
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("operator")


class Operator:
    """Builds and runs the whole control plane.

    ``cloud``/``iks``/``lbs`` default to fakes (the simulation environment);
    a real deployment injects live clients with the same surface.
    ``device`` is where every plane plans (see the module docstring).
    """

    def __init__(self, options: Options | None = None, cloud=None,
                 iks=None, lbs=None, credential_provider=None,
                 cluster: ClusterState | None = None, device="cuda"):
        self.options = options or Options.from_env()
        errs = self.options.validate()
        if errs:
            raise ValueError("invalid options: " + "; ".join(errs))
        # before anything starts a thread (the pricing batcher, the
        # window): an operator meant for the card raises without one
        self.device = resolve_device(device)

        # credential validation is boot-fatal (operator.go:80-97);
        # programmatic options.api_key outranks the environment
        if credential_provider is None and self.options.api_key:
            credential_provider = StaticCredentialProvider(
                self.options.api_key, self.options.region)
        self.credentials = CredentialStore(
            credential_provider or EnvCredentialProvider())
        self.credentials.get()

        # cloud selection (VERDICT round 1 item 3: env selects fake vs
        # real): an explicit injected client wins; TPU_CLOUD_ENDPOINT
        # builds the HTTP-backed clients; default is the in-memory fake
        # (simulation environment)
        if cloud is None and self.options.cloud_endpoint:
            from karpenter_tpu_torch.cloud.vpc import VPCCloudClient

            creds = self.credentials.get()
            cloud = VPCCloudClient(self.options.cloud_endpoint,
                                   creds.api_key,
                                   region=self.options.region)
        self.cloud = cloud if cloud is not None else \
            FakeCloud(region=self.options.region)
        if iks is None and self.options.cloud_endpoint \
                and self.options.iks_cluster_id:
            from karpenter_tpu_torch.cloud.iks import IKSClient

            iks = IKSClient(self.options.cloud_endpoint,
                            self.options.iks_cluster_id,
                            api_key=self.credentials.get().api_key)
        self.iks = iks
        self.cluster = cluster or ClusterState()
        self.unavailable = UnavailableOfferings()
        self.pricing = PricingProvider(self.cloud)
        self.instance_types = InstanceTypeProvider(
            self.cloud, self.pricing, self.unavailable,
            spot_discount_percent=self.options.spot_discount_percent)
        self.breaker = CircuitBreakerManager(self.options.circuit_breaker)

        # crash-recovery plane (docs/design/recovery.md): with a journal
        # dir configured, every mutating actuation writes a durable
        # intent ahead of its first RPC, and start() replays open
        # intents before the controllers resume; unset -> null journal
        if self.options.journal_dir:
            import os as _os

            from karpenter_tpu_torch.recovery.journal import IntentJournal

            self.journal = IntentJournal(
                _os.path.join(self.options.journal_dir, "intents.jsonl"),
                owner=self.options.leader_identity or "operator")
        else:
            from karpenter_tpu_torch.recovery.journal import NULL_JOURNAL

            self.journal = NULL_JOURNAL
        self._recovery_report = None

        self.actuator = Actuator(self.cloud, self.cluster,
                                 breaker=self.breaker,
                                 unavailable=self.unavailable,
                                 journal=self.journal)
        iks_actuator = WorkerPoolActuator(
            self.iks, self.cluster, breaker=self.breaker,
            unavailable=self.unavailable) if self.iks is not None else None
        # options.iks_cluster_id forces IKS mode (factory.go:128) — feed the
        # factory an env view derived from options, not ambient os.environ
        factory_env = {"IKS_CLUSTER_ID": self.options.iks_cluster_id} \
            if self.options.iks_cluster_id else {}
        self.factory = ProviderFactory(self.actuator, iks_actuator,
                                       env=factory_env)
        self.cloudprovider = CloudProvider(self.cluster, self.actuator,
                                           self.instance_types,
                                           factory=self.factory)
        # leader election: actuation gate shared by the provisioner and
        # every controller (ref controller-runtime leases,
        # controllers.go:37-41); single-replica default = always leader
        if self.options.leader_election_enabled:
            from karpenter_tpu_torch.core.leaderelection import LeaderElector

            self.elector = LeaderElector(
                self.cluster, identity=self.options.leader_identity)
        else:
            from karpenter_tpu_torch.core.leaderelection import AlwaysLeader

            self.elector = AlwaysLeader()
        # the resident flag resolves into the solver options BEFORE the
        # provisioner builds its solver (make_solver reads them once)
        if self.options.resident_enabled:
            self.options.solver.resident = "on"
        # the sharded flag resolves the same way: make_solver routes the
        # provisioner's solves through the sharded continuous-solve
        # service (streaming admission router + stacked per-shard
        # resident state over the shard mesh, docs/design/sharded.md)
        if self.options.sharded_shards > 1:
            self.options.solver.sharded = self.options.sharded_shards
        self.provisioner = Provisioner(
            self.cluster, self.instance_types, self.actuator,
            ProvisionerOptions(solver=self.options.solver,
                               window=self.options.window),
            factory=self.factory, leader=self.elector.is_leader,
            journal=self.journal, device=self.device)
        self.lb_provider = LoadBalancerProvider(lbs) if lbs is not None else None

        self.manager = ControllerManager(self.cluster,
                                         leader=self.elector.is_leader)
        # set by _build_controllers under KARPENTER_ENABLE_WHATIF
        self.whatif = None
        for ctrl in self._build_controllers():
            self.manager.register(ctrl)
        self.metrics_server = None
        self.webhook_server = None
        self._warmup_thread = None
        self._warmup_stop = None
        self._warmup_started = False
        self._started = False
        import threading as _threading

        self._recovered = False
        self._recover_lock = _threading.Lock()

    def _build_controllers(self) -> list:
        """The reference's registration list (controllers.go:117-259) with
        the same feature gates."""
        ctrls = [
            NodeClassHashController(self.cluster),
            NodeClassStatusController(self.cluster, self.cloud,
                                      subnet_provider=self.actuator.subnets,
                                      image_resolver=self.actuator.images),
            AutoplacementController(self.cluster, self.instance_types,
                                    self.actuator.subnets),
            NodeClassTerminationController(self.cluster),
            RegistrationController(self.cluster),
            StartupTaintController(self.cluster),
            NodeClaimTerminationController(self.cluster, self.actuator,
                                           factory=self.factory),
            GarbageCollectionController(self.cluster, self.cloud,
                                        journal=self.journal),
            TaggingController(self.cluster, self.cloud),
            SpotPreemptionController(self.cluster, self.cloud,
                                     self.unavailable,
                                     journal=self.journal),
            InstanceTypeRefreshController(self.instance_types,
                                          self.unavailable),
            PricingRefreshController(self.pricing),
        ]
        if self.options.interruption_enabled:
            ctrls.append(InterruptionController(self.cluster,
                                                self.unavailable,
                                                cloud=self.cloud))
        # bootstrap-token lifecycle (ref RegisterBootstrapController,
        # controllers.go:267 + bootstrap/token_controller.go)
        ctrls.append(BootstrapTokenController(
            self.cluster, self.actuator.bootstrap.tokens))
        # drift replacement + consolidation (karpenter-core's disruption
        # plane, owned here since the framework is standalone — §3.4)
        ctrls.append(DisruptionController(
            self.cluster, self.cloudprovider, provisioner=self.provisioner,
            repack_enabled=self.options.repack_enabled,
            repack_min_savings_fraction=(
                self.options.repack_min_savings_percent / 100.0),
            resident_occupancy=self.options.resident_enabled,
            journal=self.journal, device=self.device))
        # priority-aware preemption: stranded high-priority pods take
        # capacity from lower-priority pods on existing nodes when no
        # offering is creatable (docs/design/preemption.md)
        if self.options.preemption_enabled:
            from karpenter_tpu_torch.controllers.preemption import (
                PreemptionController,
            )

            ctrls.append(PreemptionController(
                self.cluster, self.provisioner, journal=self.journal,
                device=self.device))
        # gang admission + TPU-slice placement: whole-job atomic
        # scheduling, parked behind min_member (docs/design/gang.md).
        # Opt-in: the controller registers the provisioner's admission
        # gate, changing how gang-labeled pods are queued.
        if self.options.gang_enabled:
            from karpenter_tpu_torch.controllers.gang import (
                GangAdmissionController,
            )

            ctrls.append(GangAdmissionController(
                self.cluster, self.provisioner, journal=self.journal,
                device=self.device))
        # what-if planning service (karpenter_tpu_torch/whatif): periodic
        # stacked scenario evaluation + recommendation registry behind
        # KARPENTER_ENABLE_WHATIF (docs/design/whatif.md)
        if self.options.whatif_enabled:
            from karpenter_tpu_torch.whatif.service import (
                PlanningService, WhatIfController,
            )

            self.whatif = PlanningService(
                self.cluster, self.provisioner, journal=self.journal,
                device=self.device)
            ctrls.append(WhatIfController(self.whatif))
        # env-gated (controllers.go:238)
        ctrls.append(OrphanCleanupController(
            self.cluster, self.cloud,
            enabled=self.options.orphan_cleanup_enabled,
            journal=self.journal))
        if self.iks is not None:
            ctrls.append(PoolCleanupController(self.cluster, self.iks))
        if self.lb_provider is not None:
            ctrls.append(LoadBalancerController(self.cluster, self.lb_provider))
            ctrls.append(LBMembershipSweeper(self.cluster, self.lb_provider))
        return ctrls

    # -- introspection -----------------------------------------------------

    def statusz(self) -> dict:
        """Operator-level /statusz extras: backend + leadership + breaker
        state + the last solve's stats — the 'why is this cycle slow'
        one-pager next to /debug/traces' full causal record."""
        solver = self.provisioner.solver
        last = dict(getattr(solver, "last_stats", None) or {})
        out = {
            "backend": self.options.solver.backend,
            "started": self._started,
            "leader": bool(self.elector.is_leader()),
            "controllers": len(self.manager.controllers()),
            "circuit_breakers": {f"{k[0]}/{k[1]}": v
                                 for k, v in self.breaker.states().items()},
            "last_solve": last,
        }
        # resident-store health (generation, resident bytes, last rebuild
        # reason, delta sizes) — ResilientSolver delegates the attribute
        # to its primary; None for greedy/remote backends or flag off
        store = getattr(solver, "resident", None)
        if store is not None:
            out["resident"] = store.stats()
        # sharded-service health (shard count, mesh width, windows,
        # rebalances/migrations, backlog skew) — ResilientSolver
        # delegates `service` to the ShardedSolver primary; absent when
        # the sharded plane is off
        service = getattr(solver, "service", None)
        if service is not None and hasattr(service, "stats"):
            out["sharded"] = service.stats()
        # whatif planning block (karpenter_tpu_torch/whatif): tick counts,
        # registry size, last plan summary — absent when the plane is off
        if self.whatif is not None:
            out["whatif"] = self.whatif.snapshot()
        # crash-recovery block: journal health + what the last restart
        # recovery replayed/fenced (docs/design/recovery.md)
        recovery = {"journal": self.journal.stats()}
        if self._recovery_report is not None:
            recovery["last_recovery"] = self._recovery_report.to_dict()
        out["recovery"] = recovery
        return out

    # -- lifecycle ---------------------------------------------------------

    def _start_solver_warmup(self) -> None:
        """Cold-start tier (SURVEY.md §7.4 'ragged shapes &
        recompilation'): put the kernels' build directory in use (the
        kernels built there, once) and dispatch the common bucket ladder
        in a daemon thread, so the first provisioning window after a
        restart pays neither a kernel's first load nor the catalog
        upload (``solver/warmup.py``).  No-op for backends other than
        ``torch``; never boot-fatal.  The thread shares the
        provisioner's solver with the first window, which may already
        be solving: both issue on the device's current stream."""
        # idempotent: a follower prewarms at start(), and its deferred
        # recover() on later leadership must not spawn a second warmup
        if self._warmup_started:
            return
        self._warmup_started = True
        if self.options.solver.backend != "torch":
            return
        self.aot = None
        try:
            import os

            cache_dir = self.options.compile_cache_dir \
                or os.environ.get("KARPENTER_TPU_COMPILE_CACHE", "")
            if cache_dir:
                # the AOT signature cache (resident/aot.py) wraps the
                # kernels' build directory: it also records every NEW
                # dispatch signature into a manifest, so the warmup
                # below can replay exactly what production dispatched
                from karpenter_tpu_torch.resident.aot import AOTExecutableCache

                self.aot = AOTExecutableCache(cache_dir).enable()
            else:
                from karpenter_tpu_torch.solver.warmup import (
                    enable_persistent_compile_cache,
                )

                enable_persistent_compile_cache(None)
        except Exception as e:  # noqa: BLE001
            log.warning("compile cache setup failed", error=str(e)[:200])
        if not self.options.solver_warmup:
            return
        import threading

        self._warmup_stop = threading.Event()

        def _warm():
            try:
                import time as _time

                from karpenter_tpu_torch.catalog.arrays import CatalogArrays
                from karpenter_tpu_torch.solver.warmup import warmup_solver

                # prefer the PROVISIONER'S catalog instance: the device
                # cache keys on catalog uid, so warming a privately built
                # catalog would leave a dead upload the first window
                # cannot hit.  NodeClasses arrive via watches — wait
                # briefly for one, then fall back to a provider-wide
                # catalog (the dispatch warmup is uid-independent
                # either way).
                catalog = None
                deadline = _time.time() + 10.0
                while catalog is None and _time.time() < deadline:
                    for nc in self.cluster.list("nodeclasses"):
                        catalog = self.provisioner._catalog_for(nc)
                        if catalog is not None:
                            break
                    if catalog is None and self._warmup_stop.wait(0.5):
                        return          # shutting down: skip warmup
                if self._warmup_stop.is_set():
                    return
                if catalog is None:
                    catalog = CatalogArrays.build(self.instance_types.list())
                warmup_solver(self.provisioner.solver, catalog)
                if self.aot is not None:
                    # warm-restart tier: replay the signatures a prior
                    # process dispatched, each paying its first-dispatch
                    # costs here instead of in a window
                    self.aot.prewarm(self.provisioner.solver, catalog)
            except Exception as e:  # noqa: BLE001 — warmup is best-effort
                log.warning("solver warmup failed", error=str(e)[:200])

        # daemon (a hung device must not block exit) but joined in
        # stop(): a thread still issuing CUDA work at interpreter
        # teardown must not outlive the operator
        self._warmup_thread = threading.Thread(
            target=_warm, name="solver-warmup", daemon=True)
        self._warmup_thread.start()

    def recover(self) -> None:
        """ONE restart path (docs/design/recovery.md): replay the
        write-ahead journal's open intents against cloud + cluster
        ground truth (fence or finish each), rebuild volatile controller
        state (preempted_keys, gang admissions, nominations) from the
        journal's state records, then hand off to the AOT prewarm +
        resident rebuild tier (_start_solver_warmup), which pre-compiles
        exactly what the crashed process dispatched.

        Runs at most once per process, and the journal replay half —
        which ISSUES cloud RPCs (fence deletes, finish creates) — only
        ever runs while this replica is the leader: a restarted
        follower fencing intents against resources the live leader just
        adopted would be exactly the split-brain actuation the election
        gate exists to prevent (same rule as the manager's
        follower-skips-resync)."""
        do_replay = False
        with self._recover_lock:
            # a follower's call falls through to the warmup tail WITHOUT
            # consuming the once-flag — its replay is still owed if (and
            # when) it becomes leader
            if not self._recovered and self.elector.is_leader():
                self._recovered = True
                do_replay = True
        if do_replay and self.journal.stats().get("enabled"):
            from karpenter_tpu_torch.recovery.reconciler import Reconciler

            self._recovery_report = Reconciler(
                self.journal, self.cloud, self.cluster).recover()
            for ctrl in self.manager.controllers():
                seed = getattr(ctrl, "seed_recovered", None)
                if seed is None:
                    continue
                if ctrl.name == "preemption":
                    seed(self._recovery_report.preempted_keys)
                elif ctrl.name == "gang":
                    seed(self._recovery_report.gang_admitted,
                         self._recovery_report.gang_parked)
        self._start_solver_warmup()

    def start(self) -> None:
        """Resync existing objects, then go live (watch threads + pollers +
        the provisioning window)."""
        if self._started:
            return
        # build identity rendered before the first scrape can arrive
        # (dashboards join series against karpenter_tpu_build_info)
        from karpenter_tpu_torch.utils.metrics import record_build_info

        # the platform is the operator's device, not whether this
        # machine has a card: an operator asked for the CPU says cpu
        record_build_info(backend=self.options.solver.backend,
                          platform=self.device.type)
        # journal replay is leadership-gated: a follower defers its
        # recovery until (if ever) it becomes leader; prewarm still
        # runs either way via the deferred recover()'s warmup tail
        prior_cb = getattr(self.elector, "on_started_leading", None)

        def _recover_on_lead():
            self.recover()
            if prior_cb is not None:
                prior_cb()

        if hasattr(self.elector, "on_started_leading"):
            self.elector.on_started_leading = _recover_on_lead
        self.elector.start()
        if self.elector.is_leader():
            self.recover()
        else:
            self._start_solver_warmup()   # follower-safe prewarm only
        self.manager.sync(rounds=1)    # restart = resume (SURVEY.md §5.4)
        self.manager.start()
        self.provisioner.start()
        if self.options.metrics_port and self.metrics_server is None:
            from karpenter_tpu_torch.operator.server import MetricsServer

            self.metrics_server = MetricsServer(
                port=self.options.metrics_port,
                ready_check=lambda: self._started,
                statusz=self.statusz,
                whatif=self.whatif).start()
        if self.options.webhook_port and self.webhook_server is None:
            # dedicated TLS admission listener: the API server refuses
            # plaintext webhooks, so /validate-nodeclass must be served
            # with the cert the ValidatingWebhookConfiguration trusts
            from karpenter_tpu_torch.operator.server import MetricsServer

            self.webhook_server = MetricsServer(
                port=self.options.webhook_port,
                ready_check=lambda: self._started,
                tls_cert=self.options.webhook_tls_cert,
                tls_key=self.options.webhook_tls_key).start()
        self._started = True
        from karpenter_tpu_torch.version import get_version

        log.info("operator started",
                 version=get_version(),
                 controllers=len(self.manager.controllers()),
                 backend=self.options.solver.backend)

    def install_signal_handlers(self) -> None:
        """SIGTERM -> graceful drain (Kubernetes pod termination sends
        exactly this before the SIGKILL deadline).  Main-thread only —
        Python delivers signals nowhere else."""
        import signal

        def _on_sigterm(signum, frame):
            log.info("SIGTERM received; draining")
            self.drain()

        signal.signal(signal.SIGTERM, _on_sigterm)

    def drain(self, timeout: float = 30.0) -> None:
        """Graceful shutdown (docs/design/recovery.md): stop accepting
        solve windows, let in-flight actuation finish (or stay
        journaled — a crash past the deadline replays it), flush the
        journal and dump the recorder rings next to it, then stop.  A
        drained process leaves ZERO open intents for its successor."""
        if not self._started:
            self.stop()
            return
        with obs.span("operator.drain") as sp:
            # 1. stop intake: the window closes (pending adds resolve),
            #    controllers + pollers stop — no NEW actuation starts
            self.provisioner.stop()
            self.manager.stop()
            # 2. wait out in-flight actuation: the solve lock serializes
            #    solve+actuate, so holding it proves the plane is idle
            acquired = self.provisioner._solve_lock.acquire(timeout=timeout)
            if acquired:
                self.provisioner._solve_lock.release()
            sp.set("actuation_drained", acquired)
            # 3. flush the durable evidence: journal to disk, recorder
            #    rings to a drain bundle next to it (a post-mortem can
            #    read the final causal chains without a live /debug)
            self.journal.flush()
            if self.options.journal_dir:
                try:
                    import os as _os

                    from karpenter_tpu_torch.obs.export import (
                        dump_jsonl, recorder_to_dicts,
                    )

                    dump_jsonl(recorder_to_dicts(obs.get_recorder()),
                               _os.path.join(self.options.journal_dir,
                                             "drain-spans.jsonl"))
                except Exception as e:  # noqa: BLE001 — drain must finish
                    log.warning("drain span dump failed",
                                error=str(e)[:200])
            sp.set("open_intents",
                   self.journal.stats().get("open_intents", 0))
        self.stop()
        self.journal.close()
        log.info("operator drained",
                 open_intents=self.journal.stats().get("open_intents", 0))

    def stop(self) -> None:
        # pricing spawns its batcher thread in __init__, so it must be
        # closed even for a constructed-but-never-started operator — but
        # for a *started* one it must close only after the controllers
        # stop, or the still-running pricing/instance-type refresh pollers
        # can hit "batcher closed" mid-shutdown
        if not self._started:
            self.pricing.close()
            self.journal.close()
            return
        try:
            try:
                self.provisioner.stop()
            finally:
                # manager must stop even if the provisioner raised —
                # otherwise its refresh pollers outlive the close below
                self.manager.stop()
        finally:
            # even if a controller stop raises, the batcher thread and the
            # metrics server must not outlive the operator
            if self._warmup_thread is not None:
                self._warmup_stop.set()   # interrupt the NodeClass poll
                self._warmup_thread.join(timeout=60.0)
                self._warmup_thread = None
            self.pricing.close()
            if self.metrics_server is not None:
                self.metrics_server.stop()
                self.metrics_server = None
            if self.webhook_server is not None:
                self.webhook_server.stop()
                self.webhook_server = None
            self.elector.stop()        # release-on-cancel: hand off now
        self._started = False
        log.info("operator stopped")
