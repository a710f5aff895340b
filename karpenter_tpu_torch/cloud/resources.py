"""Cloud resource DTOs shared by every cloud-client implementation.

The provider layer (actuator, subnet/image providers, controllers) is
written against these plain dataclasses; the in-memory fake
(``cloud/fake.py``) and the HTTP-backed clients (``cloud/vpc.py``,
``cloud/iks.py``) both return them, so the two implementations are
interchangeable behind the same seam (ref ``pkg/cloudprovider/ibm/vpc.go:70``
wraps the SDK types the same way for its consumers).

(Copy of ``karpenter_tpu/cloud/resources.py``.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Instance:
    id: str
    name: str
    profile: str
    zone: str
    subnet_id: str
    image_id: str
    capacity_type: str = "on-demand"   # availability policy analogue
    status: str = "running"            # pending|running|stopped|deleting
    status_reason: str = ""
    health_state: str = "ok"           # ok|degraded|faulted (metadata svc)
    tags: dict[str, str] = field(default_factory=dict)
    security_group_ids: tuple[str, ...] = ()
    vni_id: str = ""
    volume_ids: tuple[str, ...] = ()
    user_data: str = ""
    created_at: float = field(default_factory=time.time)
    ip_address: str = ""


@dataclass
class Subnet:
    id: str
    zone: str
    total_ips: int = 256
    available_ips: int = 256
    state: str = "available"
    tags: dict[str, str] = field(default_factory=dict)
    vpc_id: str = "vpc-1"


@dataclass
class Image:
    id: str
    name: str                          # e.g. "ubuntu-24-04-amd64"
    os: str = "ubuntu"
    architecture: str = "amd64"
    status: str = "available"
    visibility: str = "public"
    created_at: float = 0.0


@dataclass
class VNI:
    id: str
    subnet_id: str


@dataclass
class Volume:
    id: str
    capacity_gb: int
    profile: str


@dataclass
class WorkerPool:
    id: str
    name: str
    flavor: str                  # instance profile name
    zones: list[str]
    size_per_zone: int
    state: str = "normal"        # normal | resizing | deleting
    labels: dict[str, str] = field(default_factory=dict)
    dynamic: bool = False        # created by karpenter (eligible for cleanup)
    created_at: float = field(default_factory=time.time)


@dataclass
class Worker:
    id: str
    pool_id: str
    zone: str
    instance_id: str             # backing VPC instance
    state: str = "provisioning"  # provisioning | deployed | deleting
