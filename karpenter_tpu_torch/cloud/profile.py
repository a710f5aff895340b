"""Raw cloud instance profile (the VPC instance-profile analogue).

Lives at the bottom of the cloud layer so both the fake cloud and the
catalog can import it without cycles.

(Copy of ``karpenter_tpu/cloud/profile.py``.)
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InstanceProfile:
    name: str                    # e.g. "bx2-4x16"
    cpu: int                     # vCPUs
    memory_gib: int
    architecture: str = "amd64"
    gpu: int = 0
    gpu_model: str = ""
    supports_spot: bool = True
    bandwidth_gbps: int = 16
