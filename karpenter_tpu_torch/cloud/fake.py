"""Stateful in-memory fake cloud.

Parity with the reference's ``pkg/fake`` doubles (fake/vpcapi.go:32-56,
108-461; atomic.go:26-96): per-method call recording, injectable
``next_error``, atomic state slices — the layer every provisioning test
runs against instead of a real cloud.

Also ships a deterministic synthetic catalog generator
(:func:`generate_profiles`) producing IBM-VPC-shaped profile ladders
(bx2 1:4, cx2 1:2, mx2 1:8, gx3 gpu) with a price model, so benchmarks can
scale the catalog to 500+ types (BASELINE.json configs).

(Copy of ``karpenter_tpu/cloud/fake.py``.)
"""

from __future__ import annotations

import itertools
import threading
from collections import defaultdict

from karpenter_tpu_torch.cloud.errors import CloudError, not_found
from karpenter_tpu_torch.cloud.profile import InstanceProfile
from karpenter_tpu_torch.cloud.resources import VNI, Image, Instance, Subnet, Volume

# Historical names — the DTOs moved to cloud/resources.py so the HTTP
# clients share them; existing imports keep working.
FakeInstance = Instance
FakeSubnet = Subnet
FakeImage = Image
FakeVNI = VNI
FakeVolume = Volume


def _snap(obj):
    """Deep-enough copy of a fake resource: mutable containers are copied so
    snapshots handed to callers are isolated from live fake-cloud state."""
    import dataclasses
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, dict):
            v = dict(v)
        elif isinstance(v, list):
            v = list(v)
        kw[f.name] = v
    return type(obj)(**kw)


class CallRecorder:
    """Per-method call capture + one-shot error injection (ref
    MockedFunction, fake/atomic.go:26-96)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.calls: dict[str, list[tuple]] = defaultdict(list)
        self._next_errors: dict[str, list[Exception]] = defaultdict(list)
        self._persistent_errors: dict[str, Exception] = {}

    def record(self, method: str, *args) -> None:
        with self._lock:
            self.calls[method].append(args)

    def call_count(self, method: str) -> int:
        with self._lock:
            return len(self.calls[method])

    def inject_error(self, method: str, err: Exception, times: int = 1) -> None:
        with self._lock:
            self._next_errors[method].extend([err] * times)

    def set_persistent_error(self, method: str, err: Exception | None) -> None:
        with self._lock:
            if err is None:
                self._persistent_errors.pop(method, None)
            else:
                self._persistent_errors[method] = err

    def maybe_raise(self, method: str) -> None:
        with self._lock:
            queue = self._next_errors[method]
            err = queue.pop(0) if queue else self._persistent_errors.get(method)
        if err is not None:
            raise err

    def reset(self) -> None:
        with self._lock:
            self.calls.clear()
            self._next_errors.clear()
            self._persistent_errors.clear()


_FAMILIES = {
    # family -> (mem_per_cpu_gib, gpu_per_8cpu, base price per cpu-hour)
    "bx2": (4, 0, 0.0475),
    "cx2": (2, 0, 0.0415),
    "mx2": (8, 0, 0.0555),
    "ux2d": (28, 0, 0.1320),
    "gx3": (8, 1, 0.4200),
}
_CPU_LADDER = (2, 4, 8, 16, 24, 32, 48, 64, 96, 128)


def generate_profiles(count: int = 20, families: tuple[str, ...] = ("bx2", "cx2", "mx2"),
                      arch: str = "amd64") -> list[InstanceProfile]:
    """Deterministic IBM-shaped profile ladder of ``count`` types."""
    out: list[InstanceProfile] = []
    for family, cpu in itertools.product(families, _CPU_LADDER):
        if len(out) >= count:
            break
        mem_ratio, gpu_per8, _ = _FAMILIES[family]
        gpu = (cpu // 8) * gpu_per8
        name = f"{family}-{cpu}x{cpu * mem_ratio}"
        out.append(InstanceProfile(name=name, cpu=cpu, memory_gib=cpu * mem_ratio,
                                   architecture=arch, gpu=gpu,
                                   supports_spot=(family != "ux2d")))
    # widen with synthetic variant suffixes when count exceeds the real ladder
    variant = 2
    while len(out) < count:
        for family, cpu in itertools.product(families, _CPU_LADDER):
            if len(out) >= count:
                break
            mem_ratio, gpu_per8, _ = _FAMILIES[family]
            name = f"{family}v{variant}-{cpu}x{cpu * mem_ratio}"
            out.append(InstanceProfile(name=name, cpu=cpu,
                                       memory_gib=cpu * mem_ratio,
                                       architecture=arch,
                                       gpu=(cpu // 8) * gpu_per8))
        variant += 1
    return out[:count]


def profile_price(profile: InstanceProfile) -> float:
    """Deterministic on-demand $/h for a synthetic profile."""
    fam = next((f for f in _FAMILIES if profile.name.startswith(f)), "bx2")
    per_cpu = _FAMILIES[fam][2]
    price = profile.cpu * per_cpu + profile.gpu * 0.95
    # mild variant premium so duplicated ladders aren't price-identical
    if "v2-" in profile.name:
        price *= 1.07
    elif "v3-" in profile.name:
        price *= 1.15
    return round(price, 4)


class FakeCloud:
    """In-memory cloud: instances, subnets, images, profiles, pricing.

    Thread-safe; every mutator records its call and honors injected errors.
    """

    def __init__(self, region: str = "us-south", zones: list[str] | None = None,
                 profiles: list[InstanceProfile] | None = None,
                 subnets_per_zone: int = 2, subnet_capacity: int = 256,
                 instance_quota: int = 100000):
        self.region = region
        self.zone_names = (zones if zones is not None
                           else [f"{region}-{i}" for i in (1, 2, 3)])
        self.recorder = CallRecorder()
        self._lock = threading.RLock()
        self._seq = itertools.count(1)
        self.profiles: list[InstanceProfile] = profiles or generate_profiles(20)
        self.instances: dict[str, FakeInstance] = {}
        self.subnets: dict[str, FakeSubnet] = {}
        self.images: dict[str, FakeImage] = {}
        self.vnis: dict[str, FakeVNI] = {}
        self.volumes: dict[str, FakeVolume] = {}
        self.security_groups: dict[str, str] = {"sg-default": "default"}
        self.default_security_group = "sg-default"
        self.vpcs: dict[str, str] = {"vpc-1": region}   # id -> region
        self.ssh_keys: dict[str, str] = {"key-1": "rsa"}  # id -> type
        self.instance_quota = instance_quota
        self.capacity_limits: dict[tuple[str, str], int] = {}  # (profile, zone) -> max
        # idempotency-key ledger (docs/design/recovery.md): a create
        # replayed with the same key returns the EXISTING resource —
        # the server-side contract the crash-recovery journal's
        # deterministic keys rely on (real clouds expect client tokens
        # the same way, e.g. IBM VPC's transaction ids)
        self.idempotency: dict[str, str] = {}
        for zi, zone in enumerate(self.zone_names):
            for si in range(subnets_per_zone):
                sid = f"subnet-{zi + 1}{si + 1}"
                self.subnets[sid] = FakeSubnet(id=sid, zone=zone,
                                               total_ips=subnet_capacity,
                                               available_ips=subnet_capacity)
        for i, (name, osname, arch, ts) in enumerate([
                ("ubuntu-24-04-amd64", "ubuntu", "amd64", 400.0),
                ("ubuntu-22-04-amd64", "ubuntu", "amd64", 300.0),
                ("ubuntu-22-04-arm64", "ubuntu", "arm64", 300.0),
                ("rhel-9-4-amd64", "rhel", "amd64", 350.0),
                ("debian-12-5-amd64", "debian", "amd64", 320.0)]):
            iid = f"img-{i + 1}"
            self.images[iid] = FakeImage(id=iid, name=name, os=osname,
                                         architecture=arch, created_at=ts)

    # -- catalog side ------------------------------------------------------

    def list_zones(self) -> list[str]:
        self.recorder.record("list_zones")
        self.recorder.maybe_raise("list_zones")
        return list(self.zone_names)

    def list_instance_profiles(self) -> list[InstanceProfile]:
        self.recorder.record("list_instance_profiles")
        self.recorder.maybe_raise("list_instance_profiles")
        return list(self.profiles)

    def get_pricing(self, profile_name: str) -> float:
        self.recorder.record("get_pricing", profile_name)
        self.recorder.maybe_raise("get_pricing")
        for p in self.profiles:
            if p.name == profile_name:
                return profile_price(p)
        raise not_found("profile", profile_name)

    # -- subnets / images / SGs -------------------------------------------

    def list_subnets(self) -> list[FakeSubnet]:
        self.recorder.record("list_subnets")
        self.recorder.maybe_raise("list_subnets")
        with self._lock:
            return [_snap(s) for s in self.subnets.values()]

    def get_subnet(self, subnet_id: str) -> FakeSubnet:
        self.recorder.record("get_subnet", subnet_id)
        self.recorder.maybe_raise("get_subnet")
        with self._lock:
            s = self.subnets.get(subnet_id)
            if s is None:
                raise not_found("subnet", subnet_id)
            return _snap(s)

    def list_images(self) -> list[FakeImage]:
        self.recorder.record("list_images")
        self.recorder.maybe_raise("list_images")
        with self._lock:
            return list(self.images.values())

    def get_default_security_group(self) -> str:
        self.recorder.record("get_default_security_group")
        self.recorder.maybe_raise("get_default_security_group")
        return self.default_security_group

    def list_security_groups(self) -> list[str]:
        """SG ids in the VPC (ref vpc.go:268-414 SG surface; consumed by
        the status controller's existence checks)."""
        self.recorder.record("list_security_groups")
        self.recorder.maybe_raise("list_security_groups")
        with self._lock:
            return list(self.security_groups)

    def list_vpcs(self) -> list[str]:
        """VPC ids visible in this region (ref status/controller.go:471
        VPC-in-region validation)."""
        self.recorder.record("list_vpcs")
        self.recorder.maybe_raise("list_vpcs")
        with self._lock:
            return [v for v, r in self.vpcs.items() if r == self.region]

    def list_ssh_keys(self) -> list[str]:
        """SSH key ids (ref status/controller.go:796 key validation)."""
        self.recorder.record("list_ssh_keys")
        self.recorder.maybe_raise("list_ssh_keys")
        with self._lock:
            return list(self.ssh_keys)

    # -- network interfaces / volumes (staged allocation) ------------------

    def _idem_hit(self, key: str, collection: dict):
        """Existing resource for a replayed idempotency key, or None.
        Caller holds the lock.  A stale entry (resource since deleted)
        falls through to a fresh create."""
        if not key:
            return None
        rid = self.idempotency.get(key)
        return collection.get(rid) if rid else None

    def find_by_idempotency(self, key: str) -> str | None:
        """Resource id previously created under ``key`` (recovery's
        fence path uses this to learn a leaked id)."""
        with self._lock:
            return self.idempotency.get(key)

    def create_vni(self, subnet_id: str,
                   idempotency_key: str = "") -> FakeVNI:
        """Standalone VNI allocation — the first stage of the reference's
        staged create (vpc/instance/provider.go:333-401); a later instance
        create attaches it, a failed create must clean it up."""
        self.recorder.record("create_vni", subnet_id)
        self.recorder.maybe_raise("create_vni")
        with self._lock:
            hit = self._idem_hit(idempotency_key, self.vnis)
            if hit is not None:
                return hit
            subnet = self.subnets.get(subnet_id)
            if subnet is None:
                raise not_found("subnet", subnet_id)
            if subnet.available_ips <= 0:
                raise CloudError(f"subnet {subnet_id} has no available IPs",
                                 409, retryable=False)
            vni = FakeVNI(id=f"vni-{next(self._seq)}", subnet_id=subnet_id)
            self.vnis[vni.id] = vni
            if idempotency_key:
                self.idempotency[idempotency_key] = vni.id
            return vni

    def create_volume(self, capacity_gb: int = 100,
                      profile: str = "general-purpose",
                      volume_id: str = "",
                      idempotency_key: str = "") -> FakeVolume:
        """Standalone volume allocation (second stage of staged create)."""
        self.recorder.record("create_volume", volume_id or capacity_gb)
        self.recorder.maybe_raise("create_volume")
        with self._lock:
            hit = self._idem_hit(idempotency_key, self.volumes)
            if hit is not None:
                return hit
            vol = FakeVolume(id=volume_id or f"vol-{next(self._seq)}",
                             capacity_gb=capacity_gb, profile=profile)
            self.volumes[vol.id] = vol
            if idempotency_key:
                self.idempotency[idempotency_key] = vol.id
            return vol

    # -- instance lifecycle ------------------------------------------------

    def create_instance(self, name: str, profile: str, zone: str, subnet_id: str,
                        image_id: str, capacity_type: str = "on-demand",
                        security_group_ids: tuple[str, ...] = (),
                        user_data: str = "", tags: dict[str, str] | None = None,
                        volumes: tuple[FakeVolume, ...] = (),
                        vni_id: str = "",
                        volume_ids: tuple[str, ...] = (),
                        idempotency_key: str = "") -> FakeInstance:
        """Create an instance.  With ``vni_id``/``volume_ids`` it ATTACHES
        pre-allocated resources (staged create); otherwise it allocates
        them implicitly (legacy one-shot path).  A replayed
        ``idempotency_key`` returns the existing instance — quota and
        validation are skipped, the work already happened."""
        self.recorder.record("create_instance", name, profile, zone, capacity_type)
        self.recorder.maybe_raise("create_instance")
        with self._lock:
            hit = self._idem_hit(idempotency_key, self.instances)
            if hit is not None:
                return _snap(hit)
            if not any(p.name == profile for p in self.profiles):
                raise CloudError(f"profile {profile!r} not found", 404)
            if zone not in self.zone_names:
                raise CloudError(f"zone {zone!r} not found", 404)
            subnet = self.subnets.get(subnet_id)
            if subnet is None:
                raise not_found("subnet", subnet_id)
            if subnet.zone != zone:
                raise CloudError(
                    f"subnet {subnet_id} is in {subnet.zone}, not {zone}", 400)
            if subnet.available_ips <= 0:
                raise CloudError(f"subnet {subnet_id} has no available IPs", 409,
                                 retryable=False)
            if image_id not in self.images:
                raise not_found("image", image_id)
            if vni_id and vni_id not in self.vnis:
                raise not_found("vni", vni_id)
            for vid in volume_ids:
                if vid not in self.volumes:
                    raise not_found("volume", vid)
            live = sum(1 for i in self.instances.values()
                       if i.status not in ("deleting",))
            if live >= self.instance_quota:
                raise CloudError("instance quota exceeded", 403,
                                 code="quota_exceeded", retryable=False)
            limit = self.capacity_limits.get((profile, zone))
            if limit is not None:
                used = sum(1 for i in self.instances.values()
                           if i.profile == profile and i.zone == zone
                           and i.status != "deleting")
                if used >= limit:
                    raise CloudError(
                        f"insufficient capacity for {profile} in {zone}", 503,
                        code="insufficient_capacity", retryable=False)
            n = next(self._seq)
            if vni_id:
                vni = self.vnis[vni_id]
            else:
                vni = FakeVNI(id=f"vni-{n}", subnet_id=subnet_id)
                self.vnis[vni.id] = vni
            if volume_ids:
                vol_ids = tuple(volume_ids)
            else:
                vols = tuple(volumes) or (FakeVolume(id=f"vol-{n}",
                                                     capacity_gb=100,
                                                     profile="general-purpose"),)
                for v in vols:
                    self.volumes[v.id] = v
                vol_ids = tuple(v.id for v in vols)
            inst = FakeInstance(
                id=f"inst-{n:06d}", name=name, profile=profile, zone=zone,
                subnet_id=subnet_id, image_id=image_id,
                capacity_type=capacity_type,
                security_group_ids=tuple(security_group_ids) or (self.default_security_group,),
                vni_id=vni.id, volume_ids=vol_ids,
                user_data=user_data, tags=dict(tags or {}),
                ip_address=f"10.0.{len(self.instances) // 250}.{len(self.instances) % 250 + 4}")
            self.instances[inst.id] = inst
            subnet.available_ips -= 1
            if idempotency_key:
                self.idempotency[idempotency_key] = inst.id
            return _snap(inst)

    def get_instance(self, instance_id: str) -> FakeInstance:
        self.recorder.record("get_instance", instance_id)
        self.recorder.maybe_raise("get_instance")
        with self._lock:
            inst = self.instances.get(instance_id)
            if inst is None:
                raise not_found("instance", instance_id)
            return _snap(inst)

    def list_instances(self) -> list[FakeInstance]:
        self.recorder.record("list_instances")
        self.recorder.maybe_raise("list_instances")
        with self._lock:
            return [_snap(i) for i in self.instances.values()]

    def delete_instance(self, instance_id: str) -> None:
        self.recorder.record("delete_instance", instance_id)
        self.recorder.maybe_raise("delete_instance")
        with self._lock:
            inst = self.instances.pop(instance_id, None)
            if inst is None:
                raise not_found("instance", instance_id)
            self.vnis.pop(inst.vni_id, None)
            for vid in inst.volume_ids:
                self.volumes.pop(vid, None)
            subnet = self.subnets.get(inst.subnet_id)
            if subnet is not None:
                subnet.available_ips = min(subnet.total_ips, subnet.available_ips + 1)

    def update_tags(self, instance_id: str, tags: dict[str, str]) -> None:
        self.recorder.record("update_tags", instance_id)
        self.recorder.maybe_raise("update_tags")
        with self._lock:
            inst = self.instances.get(instance_id)
            if inst is None:
                raise not_found("instance", instance_id)
            inst.tags.update(tags)

    def delete_vni(self, vni_id: str) -> None:
        self.recorder.record("delete_vni", vni_id)
        self.recorder.maybe_raise("delete_vni")
        with self._lock:
            self.vnis.pop(vni_id, None)

    def delete_volume(self, volume_id: str) -> None:
        self.recorder.record("delete_volume", volume_id)
        self.recorder.maybe_raise("delete_volume")
        with self._lock:
            self.volumes.pop(volume_id, None)

    # -- spot / fault simulation ------------------------------------------

    def list_spot_instances(self) -> list[FakeInstance]:
        self.recorder.record("list_spot_instances")
        self.recorder.maybe_raise("list_spot_instances")
        with self._lock:
            return [_snap(i) for i in self.instances.values()
                    if i.capacity_type == "spot"]

    def preempt_spot_instance(self, instance_id: str) -> None:
        """Test hook: simulate a spot preemption (ref marker
        'stopped_by_preemption', spot/preemption/controller.go:97)."""
        with self._lock:
            inst = self.instances.get(instance_id)
            if inst is None:
                raise not_found("instance", instance_id)
            inst.status = "stopped"
            inst.status_reason = "stopped_by_preemption"

    def fail_instance(self, instance_id: str, reason: str = "failed") -> None:
        """Test hook: mark an instance unhealthy for interruption tests."""
        with self._lock:
            inst = self.instances.get(instance_id)
            if inst is None:
                raise not_found("instance", instance_id)
            inst.status = "stopped"
            inst.status_reason = reason

    def degrade_instance(self, instance_id: str,
                         state: str = "degraded") -> None:
        """Test hook: the metadata-service health signal (ref
        interruption/controller.go:304-325) — instance still runs but its
        health_state reads degraded/faulted."""
        with self._lock:
            inst = self.instances.get(instance_id)
            if inst is None:
                raise not_found("instance", instance_id)
            inst.health_state = state

    # -- introspection -----------------------------------------------------

    def quota_status(self) -> tuple[int, int]:
        """(live instances, quota limit) — the reference introspects VPC
        quotas per resource (vpc/instance/provider.go:905-991); the fake
        exposes the single instance quota it enforces."""
        with self._lock:
            live = sum(1 for i in self.instances.values()
                       if i.status != "deleting")
            return live, self.instance_quota

    def instance_count(self) -> int:
        with self._lock:
            return len(self.instances)
