"""NodeClass: the user-facing provisioning config object.

Capability parity with the reference's ``IBMNodeClass`` CRD
(pkg/apis/v1alpha1/ibmnodeclass_types.go): spec fields, the CEL cross-field
validation rules (:481-488), and the resolved status surface (:663-726).
Validation here is plain Python (``validate()``) instead of CEL, enforced by
the nodeclass status controller and at admission by the fake kube store.

(Copy of ``karpenter_tpu/apis/nodeclass.py``.)
"""

from __future__ import annotations

import hashlib
import json
import re
import time
from dataclasses import dataclass, field, asdict

# cloud resource id shape: alphanumerics plus - _ . (loose enough for
# every provider id style, strict enough to catch whitespace/injection)
_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class ValidationError(ValueError):
    pass


# --- sub-specs -------------------------------------------------------------

@dataclass(frozen=True)
class InstanceRequirements:
    """Automatic instance-type selection criteria
    (ibmnodeclass_types.go:250-284)."""

    architecture: str = ""          # amd64 | arm64 | s390x
    min_cpu: int = 0                # cores
    min_memory_gib: int = 0
    max_hourly_price: float = 0.0   # 0 = no ceiling
    gpu: bool = False


@dataclass(frozen=True)
class SubnetSelectionCriteria:
    minimum_available_ips: int = 0
    required_tags: tuple[tuple[str, str], ...] = ()


@dataclass(frozen=True)
class PlacementStrategy:
    """Zone/subnet placement strategy (ibmnodeclass_types.go:41-82)."""

    zone_balance: str = "Balanced"  # Balanced | AvailabilityFirst | CostOptimized
    subnet_selection: SubnetSelectionCriteria = SubnetSelectionCriteria()


@dataclass(frozen=True)
class ImageSelector:
    """Semantic image selection os/major/minor/arch/variant
    (ibmnodeclass_types.go:441-479)."""

    os: str = "ubuntu"
    major_version: str = ""
    minor_version: str = ""
    architecture: str = "amd64"
    variant: str = ""


@dataclass(frozen=True)
class VolumeSpec:
    """(ibmnodeclass_types.go:302-436)"""

    capacity_gb: int = 100
    profile: str = "general-purpose"
    iops: int = 0
    bandwidth: int = 0
    encryption_key: str = ""
    delete_on_termination: bool = True


@dataclass(frozen=True)
class BlockDeviceMapping:
    device_name: str = ""
    root_volume: bool = False
    volume: VolumeSpec = VolumeSpec()


@dataclass(frozen=True)
class KubeletConfig:
    """Subset mirrored from ibmnodeclass_types.go:318-387."""

    max_pods: int = 0               # 0 = provider heuristic
    system_reserved: tuple[tuple[str, str], ...] = ()
    kube_reserved: tuple[tuple[str, str], ...] = ()
    eviction_hard: tuple[tuple[str, str], ...] = ()
    cluster_dns: tuple[str, ...] = ()


@dataclass(frozen=True)
class HealthCheck:
    protocol: str = "tcp"
    port: int = 0
    interval: int = 5
    timeout: int = 2
    retries: int = 2
    path: str = ""          # required for http/https (healthcheck.go:161)


@dataclass(frozen=True)
class LoadBalancerTarget:
    load_balancer_id: str = ""
    pool_name: str = ""
    port: int = 0
    weight: int = 50
    health_check: HealthCheck | None = None


@dataclass(frozen=True)
class LoadBalancerIntegration:
    """(ibmnodeclass_types.go:146-244)"""

    enabled: bool = False
    target_groups: tuple[LoadBalancerTarget, ...] = ()
    auto_deregister: bool = True
    registration_timeout: int = 300


@dataclass(frozen=True)
class DynamicPoolConfig:
    """IKS dynamic worker-pool config (ibmnodeclass_types.go:84-144)."""

    enabled: bool = False
    pool_name_prefix: str = "karpenter"
    empty_pool_ttl_seconds: int = 600
    cleanup_policy: str = "Delete"  # Delete | Retain


# --- spec / status ---------------------------------------------------------

@dataclass
class NodeClassSpec:
    region: str = ""
    zone: str = ""
    instance_profile: str = ""
    instance_requirements: InstanceRequirements | None = None
    image: str = ""
    image_selector: ImageSelector | None = None
    vpc: str = ""
    subnet: str = ""
    security_groups: tuple[str, ...] = ()
    ssh_keys: tuple[str, ...] = ()
    resource_group: str = ""
    placement_target: str = ""
    tags: tuple[tuple[str, str], ...] = ()
    placement_strategy: PlacementStrategy | None = None
    user_data: str = ""
    user_data_append: str = ""
    bootstrap_mode: str = "auto"    # auto | cloud-init | iks-api
    iks_cluster_id: str = ""
    iks_worker_pool_id: str = ""
    iks_dynamic_pools: DynamicPoolConfig | None = None
    load_balancer_integration: LoadBalancerIntegration | None = None
    block_device_mappings: tuple[BlockDeviceMapping, ...] = ()
    kubelet: KubeletConfig | None = None
    api_server_endpoint: str = ""


@dataclass(frozen=True)
class Condition:
    type: str
    status: str                      # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition: float = 0.0


@dataclass
class NodeClassStatus:
    """(ibmnodeclass_types.go:663-726)"""

    last_validation_time: float = 0.0
    validation_error: str = ""
    selected_instance_types: list[str] = field(default_factory=list)
    selected_subnets: list[str] = field(default_factory=list)
    resolved_security_groups: list[str] = field(default_factory=list)
    resolved_image_id: str = ""
    conditions: list[Condition] = field(default_factory=list)

    def set_condition(self, type_: str, status: str, reason: str = "",
                      message: str = "", now: float | None = None) -> None:
        now = time.time() if now is None else now
        for i, c in enumerate(self.conditions):
            if c.type == type_:
                if c.status == status and c.reason == reason and c.message == message:
                    return
                # Keep last_transition when only reason/message change.
                transition = now if c.status != status else c.last_transition
                self.conditions[i] = Condition(type_, status, reason, message, transition)
                return
        self.conditions.append(Condition(type_, status, reason, message, now))

    def condition(self, type_: str) -> Condition | None:
        for c in self.conditions:
            if c.type == type_:
                return c
        return None

    def is_ready(self) -> bool:
        c = self.condition("Ready")
        return c is not None and c.status == "True"


@dataclass
class NodeClass:
    name: str
    spec: NodeClassSpec = field(default_factory=NodeClassSpec)
    status: NodeClassStatus = field(default_factory=NodeClassStatus)
    annotations: dict[str, str] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)
    finalizers: list[str] = field(default_factory=list)
    deleted: bool = False            # deletionTimestamp analogue
    resource_version: int = 0
    uid: str = ""

    # -- hash for drift (ref hash/controller.go:62-84, hashstructure/v2) ---

    def spec_hash(self) -> str:
        """Deterministic hash of the spec for drift detection."""
        def default(o):
            if hasattr(o, "__dataclass_fields__"):
                return asdict(o)
            return str(o)
        payload = json.dumps(asdict(self.spec), sort_keys=True, default=default)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    # -- CEL-equivalent cross-field validation (ibmnodeclass_types.go:481-488)

    def validate(self) -> list[str]:
        """Returns a list of violations (empty = valid)."""
        s = self.spec
        errs: list[str] = []
        if not s.region:
            errs.append("spec.region is required")
        if bool(s.instance_profile) == bool(s.instance_requirements):
            errs.append("exactly one of spec.instanceProfile or "
                        "spec.instanceRequirements must be set")
        if s.image and s.image_selector:
            errs.append("spec.image and spec.imageSelector are mutually exclusive")
        if not s.image and not s.image_selector:
            errs.append("one of spec.image or spec.imageSelector must be set")
        if s.bootstrap_mode not in ("auto", "cloud-init", "iks-api"):
            errs.append(f"spec.bootstrapMode invalid: {s.bootstrap_mode!r}")
        if s.bootstrap_mode == "iks-api" and not s.iks_cluster_id:
            errs.append("spec.bootstrapMode=iks-api requires spec.iksClusterID")
        if s.zone and s.region and not s.zone.startswith(s.region):
            errs.append(f"spec.zone {s.zone!r} not in region {s.region!r}")
        if s.subnet and not s.subnet.startswith("subnet-") and not s.subnet.startswith("0"):
            errs.append(f"spec.subnet {s.subnet!r} is not a subnet id")
        # format checks (ref status/controller.go:222 format validation)
        for sg in s.security_groups:
            if not sg or not _ID_RE.match(sg):
                errs.append(f"spec.securityGroups entry {sg!r} is not a "
                            "security group id")
        for key in s.ssh_keys:
            if not key or not _ID_RE.match(key):
                errs.append(f"spec.sshKeys entry {key!r} is not a key id")
        if s.vpc and not _ID_RE.match(s.vpc):
            errs.append(f"spec.vpc {s.vpc!r} is not a VPC id")
        if s.instance_requirements is not None:
            r = s.instance_requirements
            if r.architecture and r.architecture not in ("amd64", "arm64",
                                                         "s390x"):
                errs.append("spec.instanceRequirements.architecture invalid")
            if r.min_cpu < 0 or r.min_memory_gib < 0 or r.max_hourly_price < 0:
                errs.append("spec.instanceRequirements values must be >= 0")
        if s.placement_strategy:
            p = s.placement_strategy
            if p.zone_balance not in ("Balanced", "AvailabilityFirst",
                                      "CostOptimized"):
                errs.append("spec.placementStrategy.zoneBalance invalid")
            if p.subnet_selection.minimum_available_ips < 0:
                errs.append("spec.placementStrategy.subnetSelection."
                            "minimumAvailableIPs must be >= 0")
        if s.kubelet is not None:
            if s.kubelet.max_pods < 0 or s.kubelet.max_pods > 1000:
                errs.append("spec.kubelet.maxPods must be in [0, 1000]")
        root_vols = [b for b in s.block_device_mappings if b.root_volume]
        if len(root_vols) > 1:
            errs.append("at most one blockDeviceMapping may be rootVolume")
        for b in s.block_device_mappings:
            if b.volume.capacity_gb < 10 or b.volume.capacity_gb > 16000:
                errs.append(f"blockDeviceMapping volume capacity "
                            f"{b.volume.capacity_gb}GB out of range [10, 16000]")
        if s.load_balancer_integration and s.load_balancer_integration.enabled:
            for tg in s.load_balancer_integration.target_groups:
                if not tg.load_balancer_id:
                    errs.append("loadBalancerIntegration targetGroups entries "
                                "require loadBalancerID")
                if not (0 < tg.port < 65536):
                    errs.append(f"loadBalancer target port {tg.port} invalid")
        return errs


# Annotation keys (ref pkg/apis/v1alpha1/annotations.go:17-36).
ANNOTATION_NODECLASS_HASH = "karpenter-tpu.sh/nodeclass-hash"
ANNOTATION_NODECLASS_HASH_VERSION = "karpenter-tpu.sh/nodeclass-hash-version"
ANNOTATION_SUBNET = "karpenter-tpu.sh/subnet-id"
ANNOTATION_SECURITY_GROUPS = "karpenter-tpu.sh/security-groups"
ANNOTATION_IMAGE = "karpenter-tpu.sh/image-id"
NODECLASS_HASH_VERSION = "v1"


# --- JSON (CRD-shaped) parsing ---------------------------------------------
# Admission requests arrive as the CRD's camelCase JSON (the shape
# deploy/crds/tpunodeclass.yaml declares); this is the webhook-side
# deserializer (ref ibmnodeclass_webhook.go decodes the same way via
# apimachinery).

def _pairs(d: dict | None) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in (d or {}).items()))


def _obj(d, allowed: tuple[str, ...], ctx: str) -> dict | None:
    """Validate a nested object: must be a dict (or None) and use only
    known keys — a misspelled nested field (minCpu for minCPU) silently
    defaulting would admit specs the controller then ignores."""
    if d is None:
        return None
    if not isinstance(d, dict):
        raise ValidationError(f"spec.{ctx} must be an object, "
                              f"got {type(d).__name__}")
    unknown = set(d) - set(allowed)
    if unknown:
        raise ValidationError(
            f"unknown fields in spec.{ctx}: {sorted(unknown)}")
    return d


def nodeclass_from_dict(doc: dict) -> "NodeClass":
    """Parse a CRD-shaped dict (metadata + camelCase spec) into a
    NodeClass.  Unknown fields — top-level OR nested — raise
    ValidationError: an admission webhook that silently drops fields
    would accept specs the controller then ignores."""
    meta = doc.get("metadata") or {}
    spec = dict(doc.get("spec") or {})
    if not isinstance(meta, dict):
        raise ValidationError("metadata must be an object")

    def take(key, default=None):
        return spec.pop(key, default)

    ir = _obj(take("instanceRequirements"),
              ("architecture", "minCPU", "minMemoryGiB", "minMemory",
               "maxHourlyPrice", "gpu"), "instanceRequirements")
    sel = _obj(take("imageSelector"),
               ("os", "majorVersion", "minorVersion", "architecture",
                "variant"), "imageSelector")
    ps = _obj(take("placementStrategy"),
              ("zoneBalance", "subnetSelection"), "placementStrategy")
    if ps is not None:
        _obj(ps.get("subnetSelection"),
             ("minimumAvailableIPs", "requiredTags"),
             "placementStrategy.subnetSelection")
    dyn = _obj(take("iksDynamicPools"),
               ("enabled", "poolNamePrefix", "emptyPoolTTLSeconds",
                "cleanupPolicy"), "iksDynamicPools")
    lbi = _obj(take("loadBalancerIntegration"),
               ("enabled", "targetGroups", "autoDeregister",
                "registrationTimeout"), "loadBalancerIntegration")
    if lbi is not None:
        for i, tg in enumerate(lbi.get("targetGroups") or ()):
            _obj(tg, ("loadBalancerID", "poolName", "port", "weight",
                      "healthCheck"), f"loadBalancerIntegration."
                                      f"targetGroups[{i}]")
            _obj(tg.get("healthCheck"),
                 ("protocol", "port", "path", "interval", "timeout",
                  "retries", "intervalSeconds", "timeoutSeconds",
                  "maxRetries"),
                 f"loadBalancerIntegration.targetGroups[{i}].healthCheck")
    bdms = take("blockDeviceMappings") or []
    for i, b in enumerate(bdms):
        _obj(b, ("deviceName", "rootVolume", "volume"),
             f"blockDeviceMappings[{i}]")
        _obj(b.get("volume"),
             ("capacityGB", "profile", "iops", "bandwidth",
              "encryptionKey", "deleteOnTermination"),
             f"blockDeviceMappings[{i}].volume")
    kubelet = _obj(take("kubelet"),
                   ("maxPods", "systemReserved", "kubeReserved",
                    "evictionHard", "clusterDNS"), "kubelet")

    parsed = NodeClassSpec(
        region=take("region", ""),
        zone=take("zone", ""),
        instance_profile=take("instanceProfile", ""),
        instance_requirements=InstanceRequirements(
            architecture=ir.get("architecture", ""),
            min_cpu=int(ir.get("minCPU", 0)),
            min_memory_gib=int(ir.get("minMemoryGiB", ir.get("minMemory", 0))),
            max_hourly_price=float(ir.get("maxHourlyPrice", 0.0)),
            gpu=bool(ir.get("gpu", False))) if ir is not None else None,
        image=take("image", ""),
        image_selector=ImageSelector(
            os=sel.get("os", "ubuntu"),
            major_version=str(sel.get("majorVersion", "")),
            minor_version=str(sel.get("minorVersion", "")),
            architecture=sel.get("architecture", "amd64"),
            variant=sel.get("variant", "")) if sel is not None else None,
        vpc=take("vpc", ""),
        subnet=take("subnet", ""),
        security_groups=tuple(take("securityGroups") or ()),
        ssh_keys=tuple(take("sshKeys") or ()),
        resource_group=take("resourceGroup", ""),
        placement_target=take("placementTarget", ""),
        tags=_pairs(take("tags")),
        placement_strategy=PlacementStrategy(
            zone_balance=ps.get("zoneBalance", "Balanced"),
            subnet_selection=SubnetSelectionCriteria(
                minimum_available_ips=int(
                    (ps.get("subnetSelection") or {})
                    .get("minimumAvailableIPs", 0)),
                required_tags=_pairs(
                    (ps.get("subnetSelection") or {}).get("requiredTags"))))
        if ps is not None else None,
        user_data=take("userData", ""),
        user_data_append=take("userDataAppend", ""),
        bootstrap_mode=take("bootstrapMode", "auto"),
        iks_cluster_id=take("iksClusterID", ""),
        iks_worker_pool_id=take("iksWorkerPoolID", ""),
        iks_dynamic_pools=DynamicPoolConfig(
            enabled=bool(dyn.get("enabled", False)),
            pool_name_prefix=dyn.get("poolNamePrefix", "karpenter"),
            empty_pool_ttl_seconds=int(dyn.get("emptyPoolTTLSeconds", 600)),
            cleanup_policy=dyn.get("cleanupPolicy", "Delete"))
        if dyn is not None else None,
        load_balancer_integration=LoadBalancerIntegration(
            enabled=bool(lbi.get("enabled", False)),
            target_groups=tuple(
                LoadBalancerTarget(
                    load_balancer_id=tg.get("loadBalancerID", ""),
                    pool_name=tg.get("poolName", ""),
                    port=int(tg.get("port", 0)),
                    weight=int(tg.get("weight", 50)),
                    # the CRD names the timings intervalSeconds/
                    # timeoutSeconds/maxRetries; the short forms are kept
                    # for programmatic callers
                    health_check=HealthCheck(
                        protocol=tg["healthCheck"].get("protocol", "tcp"),
                        port=int(tg["healthCheck"].get("port", 0)),
                        interval=int(tg["healthCheck"].get(
                            "intervalSeconds",
                            tg["healthCheck"].get("interval", 5))),
                        timeout=int(tg["healthCheck"].get(
                            "timeoutSeconds",
                            tg["healthCheck"].get("timeout", 2))),
                        retries=int(tg["healthCheck"].get(
                            "maxRetries",
                            tg["healthCheck"].get("retries", 2))),
                        path=tg["healthCheck"].get("path", ""))
                    if tg.get("healthCheck") else None)
                for tg in (lbi.get("targetGroups") or ())),
            auto_deregister=bool(lbi.get("autoDeregister", True)),
            registration_timeout=int(lbi.get("registrationTimeout", 300)))
        if lbi is not None else None,
        block_device_mappings=tuple(
            BlockDeviceMapping(
                device_name=b.get("deviceName", ""),
                root_volume=bool(b.get("rootVolume", False)),
                volume=VolumeSpec(
                    capacity_gb=int((b.get("volume") or {})
                                    .get("capacityGB", 100)),
                    profile=(b.get("volume") or {})
                    .get("profile", "general-purpose"),
                    iops=int((b.get("volume") or {}).get("iops", 0)),
                    bandwidth=int((b.get("volume") or {})
                                  .get("bandwidth", 0)),
                    encryption_key=(b.get("volume") or {})
                    .get("encryptionKey", ""),
                    delete_on_termination=bool(
                        (b.get("volume") or {})
                        .get("deleteOnTermination", True))))
            for b in bdms),
        kubelet=KubeletConfig(
            max_pods=int(kubelet.get("maxPods", 0)),
            system_reserved=_pairs(kubelet.get("systemReserved")),
            kube_reserved=_pairs(kubelet.get("kubeReserved")),
            eviction_hard=_pairs(kubelet.get("evictionHard")),
            cluster_dns=tuple(kubelet.get("clusterDNS") or ()))
        if kubelet is not None else None,
        api_server_endpoint=take("apiServerEndpoint", ""),
    )
    if spec:
        raise ValidationError(f"unknown spec fields: {sorted(spec)}")
    name = meta.get("name") or doc.get("name") or ""
    if not name:
        raise ValidationError("metadata.name is required")
    return NodeClass(name=name, spec=parsed,
                     annotations=dict(meta.get("annotations") or {}),
                     labels=dict(meta.get("labels") or {}))
