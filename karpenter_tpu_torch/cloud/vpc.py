"""HTTP-backed VPC cloud client — the real L5 counterpart to FakeCloud
(port of ``karpenter_tpu/cloud/vpc.py``).

Capability parity with the reference's concrete client layer
(``pkg/cloudprovider/ibm/client.go:31`` credential bootstrap + lazy
sub-clients; ``vpc.go:70`` VPCClient instance/subnet/image/VNI/volume ops;
``catalog.go:36`` pricing; ``iam.go:55`` token fetch/refresh): a REST
client over :class:`~karpenter_tpu_torch.cloud.http.HTTPClient` that exposes the
EXACT provider-facing surface :class:`~karpenter_tpu_torch.cloud.fake.FakeCloud`
defines, so the actuator / catalog / subnet / image providers run
unmodified against either implementation (contract tests drive both, the
real one against the local stub server in ``cloud/stub.py``).

Wire protocol (VPC-flavored JSON REST; the stub server speaks the same):

==========================================  =================================
``POST /identity/token``                    api-key -> bearer token (IAM)
``GET  /v1/zones``                          region zones
``GET  /v1/instance/profiles``              catalog profiles
``GET  /v1/pricing/{profile}``              $/h (GlobalCatalog stand-in)
``GET  /v1/subnets[/{id}]``                 subnet list/get
``GET  /v1/images``                         image list
``GET  /v1/vpcs/default/security_group``    default SG id
``POST /v1/instances``                      create (VNI+volumes server-side)
``GET  /v1/instances[/{id}]``               list/get (``?availability=spot``)
``DELETE /v1/instances/{id}``               delete
``POST /v1/instances/{id}/tags``            tag merge (Global Tagging
                                            stand-in)
``DELETE /v1/virtual_network_interfaces/{id}``  orphan VNI cleanup
``DELETE /v1/volumes/{id}``                 orphan volume cleanup
``GET  /v1/quota``                          live count + limit
==========================================  =================================

Error envelope: ``{"errors": [{"message", "code"}]}`` + status code,
parsed into the shared taxonomy by the HTTP layer (429 honors
``Retry-After`` — ``ratelimit_retry.go:39`` contract via cloud/retry.py).
"""

from __future__ import annotations


from karpenter_tpu_torch.cloud.http import HTTPClient, TokenSource
from karpenter_tpu_torch.cloud.profile import InstanceProfile
from karpenter_tpu_torch.cloud.resources import (
    VNI, Image, Instance, Subnet, Volume,
)


def instance_to_json(i: Instance) -> dict:
    return {
        "id": i.id, "name": i.name, "profile": i.profile, "zone": i.zone,
        "subnet_id": i.subnet_id, "image_id": i.image_id,
        "capacity_type": i.capacity_type, "status": i.status,
        "status_reason": i.status_reason,
        "health_state": i.health_state, "tags": dict(i.tags),
        "security_group_ids": list(i.security_group_ids),
        "vni_id": i.vni_id, "volume_ids": list(i.volume_ids),
        "user_data": i.user_data, "created_at": i.created_at,
        "ip_address": i.ip_address,
    }


def instance_from_json(d: dict) -> Instance:
    return Instance(
        id=d["id"], name=d.get("name", ""), profile=d.get("profile", ""),
        zone=d.get("zone", ""), subnet_id=d.get("subnet_id", ""),
        image_id=d.get("image_id", ""),
        capacity_type=d.get("capacity_type", "on-demand"),
        status=d.get("status", "running"),
        status_reason=d.get("status_reason", ""),
        health_state=d.get("health_state", "ok"),
        tags=dict(d.get("tags") or {}),
        security_group_ids=tuple(d.get("security_group_ids") or ()),
        vni_id=d.get("vni_id", ""),
        volume_ids=tuple(d.get("volume_ids") or ()),
        user_data=d.get("user_data", ""),
        created_at=float(d.get("created_at", 0.0)),
        ip_address=d.get("ip_address", ""))


def subnet_to_json(s: Subnet) -> dict:
    return {"id": s.id, "zone": s.zone, "total_ips": s.total_ips,
            "available_ips": s.available_ips, "state": s.state,
            "tags": dict(s.tags), "vpc_id": s.vpc_id}


def subnet_from_json(d: dict) -> Subnet:
    return Subnet(id=d["id"], zone=d.get("zone", ""),
                  total_ips=int(d.get("total_ips", 256)),
                  available_ips=int(d.get("available_ips", 256)),
                  state=d.get("state", "available"),
                  tags=dict(d.get("tags") or {}),
                  vpc_id=d.get("vpc_id", "vpc-1"))


def image_to_json(m: Image) -> dict:
    return {"id": m.id, "name": m.name, "os": m.os,
            "architecture": m.architecture, "status": m.status,
            "visibility": m.visibility, "created_at": m.created_at}


def image_from_json(d: dict) -> Image:
    return Image(id=d["id"], name=d.get("name", ""), os=d.get("os", ""),
                 architecture=d.get("architecture", "amd64"),
                 status=d.get("status", "available"),
                 visibility=d.get("visibility", "public"),
                 created_at=float(d.get("created_at", 0.0)))


def profile_to_json(p: InstanceProfile) -> dict:
    return {"name": p.name, "cpu": p.cpu, "memory_gib": p.memory_gib,
            "architecture": p.architecture, "gpu": p.gpu,
            "gpu_model": p.gpu_model, "supports_spot": p.supports_spot,
            "bandwidth_gbps": p.bandwidth_gbps}


def profile_from_json(d: dict) -> InstanceProfile:
    return InstanceProfile(
        name=d["name"], cpu=int(d.get("cpu", 0)),
        memory_gib=int(d.get("memory_gib", 0)),
        architecture=d.get("architecture", "amd64"),
        gpu=int(d.get("gpu", 0)), gpu_model=d.get("gpu_model", ""),
        supports_spot=bool(d.get("supports_spot", True)),
        bandwidth_gbps=int(d.get("bandwidth_gbps", 16)))


class VPCCloudClient:
    """Provider-facing cloud client speaking the REST protocol above.

    Same surface as :class:`FakeCloud` minus the test-only hooks
    (``preempt_spot_instance`` / ``fail_instance`` / ``capacity_limits``
    are fault injectors, not cloud API).
    """

    def __init__(self, endpoint: str, api_key: str, region: str = "",
                 timeout: float = 30.0, opener=None, sleep=None):
        self.region = region
        kw = {}
        if opener is not None:
            kw["opener"] = opener
        if sleep is not None:
            kw["sleep"] = sleep
        # the token endpoint authenticates with the api key itself —
        # no bearer token yet (ref iam.go:76)
        self._iam = HTTPClient(endpoint, "iam", timeout=timeout, **kw)
        self._api_key = api_key
        self.tokens = TokenSource(self._fetch_token)
        self.http = HTTPClient(endpoint, "vpc", token_source=self.tokens,
                               timeout=timeout, **kw)

    def _fetch_token(self) -> dict:
        return self._iam.post("/identity/token", {"apikey": self._api_key},
                              operation="token")

    # -- catalog side (ref catalog.go:84-114, vpc.go:489-514) --------------

    def list_zones(self) -> list[str]:
        return list(self.http.get("/v1/zones", "list_zones").get("zones", []))

    def list_instance_profiles(self) -> list[InstanceProfile]:
        data = self.http.get("/v1/instance/profiles", "list_profiles")
        return [profile_from_json(p) for p in data.get("profiles", [])]

    def get_pricing(self, profile_name: str) -> float:
        data = self.http.get(f"/v1/pricing/{profile_name}", "get_pricing")
        return float(data["price"])

    # -- subnets / images / SGs (ref vpc.go:234-414) -----------------------

    def list_subnets(self) -> list[Subnet]:
        data = self.http.get("/v1/subnets", "list_subnets")
        return [subnet_from_json(s) for s in data.get("subnets", [])]

    def get_subnet(self, subnet_id: str) -> Subnet:
        return subnet_from_json(
            self.http.get(f"/v1/subnets/{subnet_id}", "get_subnet"))

    def list_images(self) -> list[Image]:
        data = self.http.get("/v1/images", "list_images")
        return [image_from_json(m) for m in data.get("images", [])]

    def get_default_security_group(self) -> str:
        return self.http.get("/v1/vpcs/default/security_group",
                             "get_default_sg")["id"]

    def list_security_groups(self) -> list[str]:
        return list(self.http.get("/v1/security_groups",
                                  "list_security_groups")
                    .get("security_groups", []))

    def list_vpcs(self) -> list[str]:
        return list(self.http.get("/v1/vpcs", "list_vpcs").get("vpcs", []))

    def list_ssh_keys(self) -> list[str]:
        return list(self.http.get("/v1/keys", "list_ssh_keys")
                    .get("keys", []))

    # -- staged allocation (ref vpc.go:448-478 VNIs, :416-446 volumes) -----

    def create_vni(self, subnet_id: str, idempotency_key: str = "") -> VNI:
        data = self.http.post("/v1/virtual_network_interfaces",
                              {"subnet_id": subnet_id,
                               "idempotency_key": idempotency_key},
                              "create_vni")
        return VNI(id=data["id"], subnet_id=data.get("subnet_id", subnet_id))

    def create_volume(self, capacity_gb: int = 100,
                      profile: str = "general-purpose",
                      volume_id: str = "",
                      idempotency_key: str = "") -> Volume:
        data = self.http.post("/v1/volumes",
                              {"capacity_gb": capacity_gb, "profile": profile,
                               "volume_id": volume_id,
                               "idempotency_key": idempotency_key},
                              "create_volume")
        return Volume(id=data["id"],
                      capacity_gb=int(data.get("capacity_gb", capacity_gb)),
                      profile=data.get("profile", profile))

    # -- instance lifecycle (ref vpc.go:125-232) ---------------------------

    def create_instance(self, name: str, profile: str, zone: str,
                        subnet_id: str, image_id: str,
                        capacity_type: str = "on-demand",
                        security_group_ids: tuple[str, ...] = (),
                        user_data: str = "",
                        tags: dict[str, str] | None = None,
                        volumes: tuple[Volume, ...] = (),
                        vni_id: str = "",
                        volume_ids: tuple[str, ...] = (),
                        idempotency_key: str = "") -> Instance:
        body = {
            "name": name, "profile": profile, "zone": zone,
            "subnet_id": subnet_id, "image_id": image_id,
            "capacity_type": capacity_type,
            "security_group_ids": list(security_group_ids),
            "user_data": user_data, "tags": dict(tags or {}),
            "volumes": [{"id": v.id, "capacity_gb": v.capacity_gb,
                         "profile": v.profile} for v in volumes],
            "vni_id": vni_id, "volume_ids": list(volume_ids),
            "idempotency_key": idempotency_key,
        }
        return instance_from_json(
            self.http.post("/v1/instances", body, "create_instance"))

    def get_instance(self, instance_id: str) -> Instance:
        return instance_from_json(
            self.http.get(f"/v1/instances/{instance_id}", "get_instance"))

    def list_instances(self) -> list[Instance]:
        data = self.http.get("/v1/instances", "list_instances")
        return [instance_from_json(i) for i in data.get("instances", [])]

    def delete_instance(self, instance_id: str) -> None:
        self.http.delete(f"/v1/instances/{instance_id}", "delete_instance")

    def update_tags(self, instance_id: str, tags: dict[str, str]) -> None:
        self.http.post(f"/v1/instances/{instance_id}/tags", {"tags": tags},
                       "update_tags")

    def delete_vni(self, vni_id: str) -> None:
        self.http.delete(f"/v1/virtual_network_interfaces/{vni_id}",
                         "delete_vni")

    def delete_volume(self, volume_id: str) -> None:
        self.http.delete(f"/v1/volumes/{volume_id}", "delete_volume")

    # -- spot (ref vpc.go:191) ---------------------------------------------

    def list_spot_instances(self) -> list[Instance]:
        data = self.http.get("/v1/instances?availability=spot",
                             "list_spot_instances")
        return [instance_from_json(i) for i in data.get("instances", [])]

    # -- introspection (ref vpc/instance/provider.go:905-991) --------------

    def quota_status(self) -> tuple[int, int]:
        data = self.http.get("/v1/quota", "quota_status")
        return int(data["live"]), int(data["limit"])

    def instance_count(self) -> int:
        return len(self.list_instances())
