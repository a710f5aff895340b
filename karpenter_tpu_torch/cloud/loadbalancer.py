"""Load balancer provider: node registration in LB pools
(port of ``karpenter_tpu/cloud/loadbalancer.py``).

Capability parity with ``pkg/providers/loadbalancer/``:

- ``register_instance`` adds the node to each configured target pool
  (provider.go:69,137-178) and optionally waits for the member to report
  healthy by POLLING the member through the API (:246-274 — a 10s ticker
  against GetLoadBalancerPoolMember, not a local sleep);
- ``deregister_instance`` finds the member by instance id and skips
  silently when it is already gone (:180-207);
- the health-check manager DIFFS desired config against the pool and
  patches only the drifted fields (``build_health_check_patch``,
  healthcheck.go:77-145), leaving pools with no configured HC on their
  defaults (:44-49);
- ``validate_health_check`` / ``validate_integration`` mirror the
  reference's ranges (healthcheck.go:150-189, provider.go:277).

The fake LB state lives here too (the reference talks to VPC LB REST;
tests use pkg/fake).  Members carry the VPC member lifecycle:
``provisioning_status`` create_pending -> active (-> delete_pending) and
``health`` unknown -> ok | faulted.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from karpenter_tpu_torch.apis.nodeclass import (
    HealthCheck, LoadBalancerIntegration, LoadBalancerTarget,
)
from karpenter_tpu_torch.cloud.errors import (
    CloudError, is_not_found, not_found,
)
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("cloud.loadbalancer")

# reference defaults (healthcheck.go:80-100)
_HC_DEFAULT_PROTOCOL = "tcp"
_HC_DEFAULT_INTERVAL = 30
_HC_DEFAULT_TIMEOUT = 5
_HC_DEFAULT_RETRIES = 2


@dataclass
class PoolMember:
    id: str
    address: str
    port: int
    weight: int = 50
    instance_id: str = ""
    health: str = "unknown"               # unknown | ok | faulted
    provisioning_status: str = "create_pending"   # -> active -> delete_pending
    created_at: float = field(default_factory=time.time)


@dataclass
class PoolHealthMonitor:
    """The pool's applied health-monitor config (vpcv1
    LoadBalancerPoolHealthMonitor analogue: delay/max_retries/timeout/
    type/url_path)."""

    delay: int = _HC_DEFAULT_INTERVAL
    max_retries: int = _HC_DEFAULT_RETRIES
    timeout: int = _HC_DEFAULT_TIMEOUT
    type: str = _HC_DEFAULT_PROTOCOL
    url_path: str = ""


@dataclass
class FakePool:
    id: str
    lb_id: str
    name: str
    members: dict[str, PoolMember] = field(default_factory=dict)
    protocol: str = _HC_DEFAULT_PROTOCOL
    health_monitor: PoolHealthMonitor | None = None   # None = pool defaults


class FakeLoadBalancers:
    """In-memory LB API double (pool/member CRUD, ref vpc.go:516-669).

    ``settle_after`` models the VPC member lifecycle: a member stays
    create_pending/unknown for that long, then flips active/ok (or
    active/faulted when its address was marked via ``fault_address``).
    """

    def __init__(self, healthy_after: float = 0.0):
        self._lock = threading.RLock()
        self.pools: dict[tuple[str, str], FakePool] = {}   # (lb, pool name)
        self.known_lbs: set = set()
        self._seq = 0
        self.healthy_after = healthy_after   # member settle delay
        self._faulted_addresses: set = set()

    # -- LB / pool surface (ref vpc.go:516-588) ----------------------------

    def create_load_balancer(self, lb_id: str) -> None:
        with self._lock:
            self.known_lbs.add(lb_id)

    def get_load_balancer(self, lb_id: str) -> str:
        with self._lock:
            if self.known_lbs and lb_id not in self.known_lbs:
                raise not_found("load_balancer", lb_id)
            return lb_id

    def ensure_pool(self, lb_id: str, pool_name: str) -> FakePool:
        with self._lock:
            self.known_lbs.add(lb_id)
            key = (lb_id, pool_name)
            if key not in self.pools:
                self._seq += 1
                self.pools[key] = FakePool(id=f"lbpool-{self._seq}",
                                           lb_id=lb_id, name=pool_name)
            return self.pools[key]

    def get_pool(self, lb_id: str, pool_name: str) -> FakePool:
        with self._lock:
            pool = self.pools.get((lb_id, pool_name))
            if pool is None:
                raise not_found("lb_pool", f"{lb_id}/{pool_name}")
            return pool

    def update_pool(self, lb_id: str, pool_name: str, patch: dict) -> FakePool:
        """Apply a health-check patch map (ref UpdateLoadBalancerPool)."""
        with self._lock:
            pool = self.get_pool(lb_id, pool_name)
            if "protocol" in patch:
                pool.protocol = patch["protocol"]
            hm = patch.get("health_monitor")
            if hm:
                pool.health_monitor = PoolHealthMonitor(
                    delay=int(hm.get("delay", _HC_DEFAULT_INTERVAL)),
                    max_retries=int(hm.get("max_retries",
                                           _HC_DEFAULT_RETRIES)),
                    timeout=int(hm.get("timeout", _HC_DEFAULT_TIMEOUT)),
                    type=hm.get("type", _HC_DEFAULT_PROTOCOL),
                    url_path=hm.get("url_path", ""))
            return pool

    # -- members (ref vpc.go:590-669) --------------------------------------

    def add_member(self, lb_id: str, pool_name: str, address: str, port: int,
                   weight: int, instance_id: str = "") -> PoolMember:
        with self._lock:
            pool = self.get_pool(lb_id, pool_name)
            for m in pool.members.values():
                if m.address == address and m.port == port:
                    return m   # idempotent
            self._seq += 1
            member = PoolMember(id=f"member-{self._seq}", address=address,
                                port=port, weight=weight,
                                instance_id=instance_id)
            pool.members[member.id] = member
            return member

    def get_member(self, lb_id: str, pool_name: str,
                   member_id: str) -> PoolMember:
        """(ref GetLoadBalancerPoolMember — the wait-healthy poll target).
        Reads advance the simulated lifecycle."""
        with self._lock:
            pool = self.get_pool(lb_id, pool_name)
            member = pool.members.get(member_id)
            if member is None:
                raise not_found("lb_member", member_id)
            self._advance(member)
            return member

    def find_member_by_instance(self, lb_id: str, pool_name: str,
                                instance_id: str) -> PoolMember | None:
        """(ref findMemberByInstanceID, provider.go:225)"""
        with self._lock:
            pool = self.get_pool(lb_id, pool_name)
            for m in pool.members.values():
                if m.instance_id == instance_id:
                    return m
            return None

    def remove_member(self, lb_id: str, pool_name: str, address: str) -> int:
        with self._lock:
            pool = self.get_pool(lb_id, pool_name)
            gone = [mid for mid, m in pool.members.items()
                    if m.address == address]
            for mid in gone:
                pool.members[mid].provisioning_status = "delete_pending"
                del pool.members[mid]
            return len(gone)

    def delete_member(self, lb_id: str, pool_name: str,
                      member_id: str) -> None:
        with self._lock:
            pool = self.get_pool(lb_id, pool_name)
            if member_id not in pool.members:
                raise not_found("lb_member", member_id)
            pool.members[member_id].provisioning_status = "delete_pending"
            del pool.members[member_id]

    def member_health(self, member: PoolMember) -> str:
        with self._lock:
            self._advance(member)
            return member.health

    def fault_address(self, address: str) -> None:
        """Test hook: members at this address settle faulted, not ok."""
        with self._lock:
            self._faulted_addresses.add(address)

    def _advance(self, member: PoolMember) -> None:
        if member.provisioning_status == "create_pending" and \
                time.time() - member.created_at >= self.healthy_after:
            member.provisioning_status = "active"
            member.health = "faulted" \
                if member.address in self._faulted_addresses else "ok"


# ---------------------------------------------------------------------------
# Health-check manager (healthcheck.go:44-189)
# ---------------------------------------------------------------------------

def build_health_check_patch(desired: HealthCheck, pool: FakePool
                             ) -> tuple[bool, dict]:
    """Diff desired HC config against the pool's applied state; returns
    (needs_update, patch map).  Mirrors buildHealthCheckPatch
    (healthcheck.go:77-145): defaults tcp/30s/5s/2 retries; url_path only
    for http(s) with a path; untouched fields stay out of the patch."""
    patch: dict = {}
    protocol = desired.protocol or _HC_DEFAULT_PROTOCOL
    interval = desired.interval or _HC_DEFAULT_INTERVAL
    timeout = desired.timeout or _HC_DEFAULT_TIMEOUT
    retries = desired.retries or _HC_DEFAULT_RETRIES

    if pool.protocol != protocol:
        patch["protocol"] = protocol

    hm = pool.health_monitor
    needs_monitor = hm is None or (
        hm.delay != interval or hm.max_retries != retries
        or hm.timeout != timeout or hm.type != protocol
        or (protocol in ("http", "https") and desired.path
            and hm.url_path != desired.path))
    if needs_monitor:
        monitor: dict = {"delay": interval, "max_retries": retries,
                         "timeout": timeout, "type": protocol}
        if protocol in ("http", "https") and desired.path:
            monitor["url_path"] = desired.path
        patch["health_monitor"] = monitor
    return bool(patch), patch


def validate_health_check(hc: HealthCheck | None) -> list[str]:
    """(ref ValidateHealthCheck, healthcheck.go:150-189)"""
    if hc is None:
        return []
    errs: list[str] = []
    if hc.protocol not in ("", "tcp", "http", "https"):
        errs.append(f"invalid health check protocol: {hc.protocol}")
    if hc.protocol in ("http", "https") and not hc.path:
        errs.append("path is required for HTTP/HTTPS health checks")
    if hc.path and not hc.path.startswith("/"):
        errs.append(f"invalid health check path: {hc.path}")
    if hc.port and not (1 <= hc.port <= 65535):
        errs.append(f"health check port {hc.port} out of range")
    if hc.interval and not (5 <= hc.interval <= 300):
        errs.append("health check interval must be between 5 and 300 seconds")
    if hc.timeout and not (1 <= hc.timeout <= 60):
        errs.append("health check timeout must be between 1 and 60 seconds")
    if hc.retries and not (1 <= hc.retries <= 10):
        errs.append("health check retry count must be between 1 and 10")
    if hc.interval and hc.timeout and hc.timeout >= hc.interval:
        errs.append(f"health check timeout ({hc.timeout}) must be less "
                    f"than interval ({hc.interval})")
    return errs


def validate_integration(integration: LoadBalancerIntegration) -> list[str]:
    """Static spec validation (ref provider.go:277 + per-target HC rules)."""
    errs: list[str] = []
    if not integration.enabled:
        return errs
    if not integration.target_groups:
        errs.append("loadBalancerIntegration.enabled requires targetGroups")
    for i, tg in enumerate(integration.target_groups):
        prefix = f"targetGroups[{i}]"
        if not tg.load_balancer_id:
            errs.append(f"{prefix}.loadBalancerID is required")
        if not tg.pool_name:
            errs.append(f"{prefix}.poolName is required")
        if not (1 <= tg.port <= 65535):
            errs.append(f"{prefix}.port {tg.port} out of range")
        if not (0 <= tg.weight <= 100):
            errs.append(f"{prefix}.weight {tg.weight} out of range")
        errs.extend(f"{prefix}.healthCheck: {e}"
                    for e in validate_health_check(tg.health_check))
    return errs


class LoadBalancerProvider:
    def __init__(self, lbs: FakeLoadBalancers | None = None,
                 poll_interval: float = 0.05):
        self.lbs = lbs or FakeLoadBalancers()
        # the reference polls every 10s (provider.go:252); tests shrink it
        self.poll_interval = poll_interval

    # -- registration (provider.go:69,137-178) -----------------------------

    def register_instance(self, integration: LoadBalancerIntegration,
                          address: str, instance_id: str = "",
                          wait_healthy: bool = False,
                          timeout: float = 5.0) -> list[str]:
        """Adds the node to every target pool; returns member ids.  HC
        config is reconciled per pool through the diff-driven patch
        builder BEFORE the member lands, so a newly-registered node is
        probed with the desired settings from its first check."""
        errs = validate_integration(integration)
        if errs:
            raise CloudError("invalid loadBalancerIntegration: " +
                             "; ".join(errs), 400, retryable=False)
        member_ids: list[str] = []
        for tg in integration.target_groups:
            self.lbs.ensure_pool(tg.load_balancer_id, tg.pool_name)
            if tg.health_check is not None:
                self.configure_health_check(tg)
            member = self.lbs.add_member(tg.load_balancer_id, tg.pool_name,
                                         address, tg.port, tg.weight,
                                         instance_id=instance_id)
            member_ids.append(member.id)
            metrics.API_REQUESTS.labels("lb", "add_member", "ok").inc()
            if wait_healthy:
                self.wait_member_healthy(tg.load_balancer_id, tg.pool_name,
                                         member.id, timeout)
        return member_ids

    def configure_health_check(self, tg: LoadBalancerTarget) -> bool:
        """(ref ConfigureHealthCheck, healthcheck.go:44-75): no desired HC
        -> pool defaults untouched; otherwise patch only on drift.
        Returns whether a patch was applied."""
        if tg.health_check is None:
            return False
        pool = self.lbs.get_pool(tg.load_balancer_id, tg.pool_name)
        needs, patch = build_health_check_patch(tg.health_check, pool)
        if not needs:
            return False
        self.lbs.update_pool(tg.load_balancer_id, tg.pool_name, patch)
        metrics.API_REQUESTS.labels("lb", "update_pool", "ok").inc()
        log.info("health check patched", lb=tg.load_balancer_id,
                 pool=tg.pool_name, fields=sorted(patch))
        return True

    # -- deregistration (provider.go:98,180-207) ---------------------------

    def deregister_instance(self, integration: LoadBalancerIntegration,
                            address: str, instance_id: str = "") -> int:
        """Remove the node from each pool — by instance id when known
        (the reference's member lookup, provider.go:180-207), by address
        otherwise.  Continues past per-pool failures like the reference's
        per-target loop; the failure count is surfaced via
        :meth:`remove_targets` for callers that must retry."""
        removed, _ = self.remove_targets(integration.target_groups, address,
                                         instance_id=instance_id)
        return removed

    def remove_targets(self, targets, address: str,
                       instance_id: str = "") -> tuple[int, int]:
        """Remove the node from each target pool; returns
        (members_removed, failures).  Lookup by ``instance_id`` when
        given (members already gone are skipped silently,
        provider.go:195), by address otherwise.  A non-zero failure count
        means the caller must retry — the member may still be serving
        traffic."""
        removed = failures = 0
        for tg in targets:
            try:
                if instance_id:
                    member = self.lbs.find_member_by_instance(
                        tg.load_balancer_id, tg.pool_name, instance_id)
                    if member is None:
                        continue
                    self.lbs.delete_member(tg.load_balancer_id, tg.pool_name,
                                           member.id)
                    removed += 1
                else:
                    removed += self.lbs.remove_member(
                        tg.load_balancer_id, tg.pool_name, address)
                metrics.API_REQUESTS.labels("lb", "remove_member", "ok").inc()
            except CloudError as e:
                if is_not_found(e):
                    continue   # pool/member gone = nothing left to remove
                failures += 1
                metrics.API_REQUESTS.labels("lb", "remove_member", "error").inc()
                log.warning("deregister failed", lb=tg.load_balancer_id,
                            pool=tg.pool_name, error=str(e))
        return removed, failures

    # -- wait-healthy (provider.go:246-274) --------------------------------

    def wait_member_healthy(self, lb_id: str, pool_name: str, member_id: str,
                            timeout: float) -> None:
        """Poll the member THROUGH THE API until health == ok.  A member
        that settles faulted fails immediately (no point burning the
        whole timeout on a dead backend); transient get errors are
        retried like the reference's poll loop."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                member = self.lbs.get_member(lb_id, pool_name, member_id)
            except CloudError as e:
                if is_not_found(e):
                    raise
                time.sleep(self.poll_interval)
                continue
            if member.health == "ok":
                return
            if member.health == "faulted":
                raise CloudError(
                    f"member {member_id} faulted in pool {pool_name}",
                    503, code="member_faulted", retryable=True)
            time.sleep(self.poll_interval)
        raise CloudError(f"member {member_id} not healthy after {timeout}s",
                         408, code="timeout", retryable=True)

    # -- configuration validation against the live API (provider.go:277) ----

    def validate_configuration(self,
                               integration: LoadBalancerIntegration
                               ) -> list[str]:
        """Spec rules plus existence checks: LB reachable, pool present."""
        errs = validate_integration(integration)
        if errs or not integration.enabled:
            return errs
        for i, tg in enumerate(integration.target_groups):
            try:
                self.lbs.get_load_balancer(tg.load_balancer_id)
            except CloudError:
                errs.append(f"target group {i}: load balancer "
                            f"{tg.load_balancer_id} not found")
                continue
            try:
                self.lbs.get_pool(tg.load_balancer_id, tg.pool_name)
            except CloudError:
                errs.append(f"target group {i}: pool {tg.pool_name} "
                            f"not found")
        return errs
