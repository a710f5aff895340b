"""Layered options/flag system (port of
``karpenter_tpu/operator/options.py``).

Capability parity with ``pkg/operator/options/options.go``: env + flag
config with validation (:250) — interruption toggle, region/zone/resource
group, ``SpotDiscountPercent`` (spot price = % of on-demand, default 60,
:76), the full ``CIRCUIT_BREAKER_*`` env family (:154-221 — parsed by
CircuitBreakerConfig.from_env), plus this build's solver block (backend,
window) gated the same way so the default path stays untouched
(SURVEY.md §5.6).

The solver backends are ``greedy`` (the host oracle), ``torch`` (the
default: ``TorchSolver`` on the card) and ``remote`` (a sidecar).
``make_solver`` builds ``TorchSolver`` for any other name, so
``validate`` is what refuses a stale ``KARPENTER_SOLVER_BACKEND=jax``:
an operator booted with that name would solve on the card while every
count keyed by the backend (``SOLVE_DURATION{torch}``) read under
another label.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from collections.abc import Mapping

from karpenter_tpu_torch.core.circuitbreaker import CircuitBreakerConfig
from karpenter_tpu_torch.core.window import WindowOptions
from karpenter_tpu_torch.solver.types import SolverOptions

SOLVER_BACKENDS = ("greedy", "torch", "remote")


def _getf(env: Mapping[str, str], key: str, default: float) -> float:
    try:
        return float(env.get(key, default))
    except (TypeError, ValueError):
        return default


def _geti(env: Mapping[str, str], key: str, default: int) -> int:
    try:
        return int(env.get(key, default))
    except (TypeError, ValueError):
        return default


def _getb(env: Mapping[str, str], key: str, default: bool) -> bool:
    raw = env.get(key)
    if raw is None:
        return default
    return raw.lower() in ("1", "true", "yes", "on")


@dataclass
class Options:
    # identity / placement (ref options.go:41-77)
    region: str = ""
    zone: str = ""
    resource_group: str = ""
    api_key: str = ""                 # cloud API credential (validated at boot)
    cloud_endpoint: str = ""          # cloud REST endpoint; set -> real
                                      # HTTP clients instead of the fakes
    iks_cluster_id: str = ""          # forces IKS mode when set (factory.go:128)

    # behavior toggles
    interruption_enabled: bool = True
    # a pod-EVICTING plane ships opt-in, like repack and orphan cleanup:
    # upgrading clusters whose priorities were decorative must not start
    # losing low-priority pods without an operator decision
    preemption_enabled: bool = False       # KARPENTER_ENABLE_PREEMPTION
    # the gang plane ships opt-in like preemption/repack: it HOLDS pods
    # out of the provision queue, and an upgrading cluster whose gang
    # labels were decorative must not start parking workloads without an
    # operator decision
    gang_enabled: bool = False             # KARPENTER_ENABLE_GANG
    orphan_cleanup_enabled: bool = False   # KARPENTER_ENABLE_ORPHAN_CLEANUP
    repack_enabled: bool = False           # KARPENTER_ENABLE_REPACK
    # device-resident cluster state + delta-encoded incremental solves
    # (karpenter_tpu_torch/resident/, docs/design/resident.md): opt-in like
    # preemption/gang/repack — it changes what lives on device between
    # windows and how the repack plane snapshots occupancy
    resident_enabled: bool = False         # KARPENTER_ENABLE_RESIDENT
    # persistent device-resident serving loop (karpenter_tpu_torch/serving/,
    # docs/design/serving.md): opt-in like resident — ring-fed windows
    # replace per-window dispatch for steady-state traffic
    serving_enabled: bool = False          # KARPENTER_ENABLE_SERVING
    # sharded continuous-solve service (karpenter_tpu_torch/sharded/,
    # docs/design/sharded.md): opt-in like resident — 0 = off, N > 1 =
    # shard cluster state across N per-shard device-resident buffers
    # behind the streaming admission router
    sharded_shards: int = 0                # KARPENTER_ENABLE_SHARDED /
                                           # KARPENTER_SHARDS
    # what-if planning service (karpenter_tpu_torch/whatif/,
    # docs/design/whatif.md): opt-in like the other planes — it runs
    # periodic stacked scenario solves against the live pending window
    # and serves /debug/whatif + recommendation metrics
    whatif_enabled: bool = False           # KARPENTER_ENABLE_WHATIF
    repack_min_savings_percent: int = 15   # apply repack only above this
    spot_discount_percent: int = 60        # spot = % of on-demand (options.go:76)
    metrics_port: int = 0                  # 0 = metrics server disabled
    webhook_port: int = 0                  # 0 = TLS admission listener off
    webhook_tls_cert: str = ""             # serving cert path (webhook)
    webhook_tls_key: str = ""              # serving key path (webhook)
    leader_election_enabled: bool = False  # lease-based single-active gate
    leader_identity: str = ""              # defaults to a random identity
    # cold-start tier (first solve after restart must not pay the kernel
    # build or catalog upload): kernel build dir + boot warmup
    compile_cache_dir: str = ""            # KARPENTER_TPU_COMPILE_CACHE
    solver_warmup: bool = True             # KARPENTER_TPU_WARMUP
    # crash-recovery plane (karpenter_tpu_torch/recovery): directory for the
    # write-ahead intent journal; set -> every mutating actuation is
    # journaled and operator start replays open intents
    # (docs/design/recovery.md)
    journal_dir: str = ""                  # KARPENTER_JOURNAL_DIR

    # sub-configs
    circuit_breaker: CircuitBreakerConfig = field(
        default_factory=CircuitBreakerConfig)
    solver: SolverOptions = field(default_factory=SolverOptions)
    window: WindowOptions = field(default_factory=WindowOptions)

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None) -> "Options":
        env = os.environ if env is None else env
        solver = SolverOptions(
            backend=env.get("KARPENTER_SOLVER_BACKEND", "torch"),
            address=env.get("KARPENTER_SOLVER_ADDRESS", ""))
        window = WindowOptions(
            idle_seconds=_getf(env, "KARPENTER_WINDOW_IDLE_SECONDS", 1.0),
            max_seconds=_getf(env, "KARPENTER_WINDOW_MAX_SECONDS", 10.0),
            max_pods=_geti(env, "KARPENTER_WINDOW_MAX_PODS", 10000))
        from karpenter_tpu_torch.operator.credentials import (
            resolve_api_key, resolve_region,
        )
        return cls(
            region=resolve_region(env),
            zone=env.get("TPU_CLOUD_ZONE", ""),
            resource_group=env.get("TPU_CLOUD_RESOURCE_GROUP", ""),
            api_key=resolve_api_key(env),
            cloud_endpoint=env.get("TPU_CLOUD_ENDPOINT", ""),
            iks_cluster_id=env.get("IKS_CLUSTER_ID", ""),
            interruption_enabled=_getb(env, "KARPENTER_ENABLE_INTERRUPTION",
                                       True),
            preemption_enabled=_getb(env, "KARPENTER_ENABLE_PREEMPTION",
                                     False),
            gang_enabled=_getb(env, "KARPENTER_ENABLE_GANG", False),
            metrics_port=_geti(env, "KARPENTER_METRICS_PORT", 0),
            webhook_port=_geti(env, "KARPENTER_WEBHOOK_PORT", 0),
            webhook_tls_cert=env.get("KARPENTER_WEBHOOK_TLS_CERT", ""),
            webhook_tls_key=env.get("KARPENTER_WEBHOOK_TLS_KEY", ""),
            leader_election_enabled=_getb(
                env, "KARPENTER_LEADER_ELECTION", False),
            leader_identity=env.get("POD_NAME", ""),
            orphan_cleanup_enabled=_getb(env, "KARPENTER_ENABLE_ORPHAN_CLEANUP",
                                         False),
            repack_enabled=_getb(env, "KARPENTER_ENABLE_REPACK", False),
            resident_enabled=_getb(env, "KARPENTER_ENABLE_RESIDENT", False),
            serving_enabled=_getb(env, "KARPENTER_ENABLE_SERVING", False),
            sharded_shards=(_geti(env, "KARPENTER_SHARDS", 2)
                            if _getb(env, "KARPENTER_ENABLE_SHARDED",
                                     False) else 0),
            whatif_enabled=_getb(env, "KARPENTER_ENABLE_WHATIF", False),
            repack_min_savings_percent=_geti(
                env, "KARPENTER_REPACK_MIN_SAVINGS_PERCENT", 15),
            spot_discount_percent=_geti(env, "KARPENTER_SPOT_DISCOUNT_PERCENT",
                                        60),
            compile_cache_dir=env.get("KARPENTER_TPU_COMPILE_CACHE", ""),
            solver_warmup=_getb(env, "KARPENTER_TPU_WARMUP", True),
            journal_dir=env.get("KARPENTER_JOURNAL_DIR", ""),
            circuit_breaker=CircuitBreakerConfig.from_env(env),
            solver=solver, window=window)

    def validate(self) -> list[str]:
        """(ref options.go:250)"""
        errs: list[str] = []
        if not self.region:
            errs.append("region is required (TPU_CLOUD_REGION)")
        if self.zone and self.region and not self.zone.startswith(self.region):
            errs.append(f"zone {self.zone!r} not in region {self.region!r}")
        if not (0 <= self.spot_discount_percent <= 100):
            errs.append("spot_discount_percent must be in [0, 100]")
        if self.solver.backend not in SOLVER_BACKENDS:
            errs.append(f"solver backend invalid: {self.solver.backend!r} "
                        f"(one of {', '.join(SOLVER_BACKENDS)})")
        if self.webhook_port and not (self.webhook_tls_cert
                                      and self.webhook_tls_key):
            # a plaintext admission listener is worse than none: the API
            # server refuses it and failurePolicy=Fail then rejects every
            # NodeClass write with no hint at the cause
            errs.append("webhook_port requires KARPENTER_WEBHOOK_TLS_CERT "
                        "and KARPENTER_WEBHOOK_TLS_KEY")
        if self.solver.backend == "remote" and not self.solver.address:
            errs.append("solver backend 'remote' requires "
                        "KARPENTER_SOLVER_ADDRESS")
        if self.window.idle_seconds <= 0 or \
                self.window.max_seconds < self.window.idle_seconds:
            errs.append("window timing invalid (idle > 0, max >= idle)")
        if self.window.max_pods < 1:
            errs.append("window max_pods must be >= 1")
        return errs
