"""Scheduling requirements: label-key operators over value sets.

Capability parity with Kubernetes/Karpenter NodeSelectorRequirement semantics
as consumed by the reference's compatibility filter
(pkg/cloudprovider/cloudprovider.go:321-352): In / NotIn / Exists /
DoesNotExist / Gt / Lt over node label values.

These requirements are the *host-side* representation; the solver encodes
them into boolean compatibility masks (pods x offerings) before the device
solve (see solver/encode.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from collections.abc import Iterable


class Operator(str, enum.Enum):
    IN = "In"
    NOT_IN = "NotIn"
    EXISTS = "Exists"
    DOES_NOT_EXIST = "DoesNotExist"
    GT = "Gt"
    LT = "Lt"


# Well-known label keys (mirrors karpenter/k8s well-known labels).
LABEL_ARCH = "kubernetes.io/arch"
LABEL_OS = "kubernetes.io/os"
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_REGION = "topology.kubernetes.io/region"
LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
LABEL_CAPACITY_TYPE = "karpenter.sh/capacity-type"
LABEL_NODEPOOL = "karpenter.sh/nodepool"
LABEL_INSTANCE_FAMILY = "karpenter-tpu.sh/instance-family"
LABEL_INSTANCE_SIZE = "karpenter-tpu.sh/instance-size"
LABEL_HOSTNAME = "kubernetes.io/hostname"

CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_SPOT = "spot"


@dataclass(frozen=True)
class Requirement:
    key: str
    operator: Operator
    values: tuple[str, ...] = ()

    def matches(self, labels: dict[str, str]) -> bool:
        """Does a node with these labels satisfy the requirement?"""
        present = self.key in labels
        value = labels.get(self.key)
        op = self.operator
        if op == Operator.IN:
            return present and value in self.values
        if op == Operator.NOT_IN:
            return not present or value not in self.values
        if op == Operator.EXISTS:
            return present
        if op == Operator.DOES_NOT_EXIST:
            return not present
        if op in (Operator.GT, Operator.LT):
            if not present or not self.values:
                return False
            left, right = _num(value), _num(self.values[0])
            if left is None or right is None:
                return False
            return left > right if op == Operator.GT else left < right
        raise ValueError(f"unknown operator {op}")

    def allows_value(self, value: str | None) -> bool:
        """Does the requirement allow a specific value for its key
        (value None = label absent)?"""
        labels = {} if value is None else {self.key: value}
        return self.matches(labels)

    @property
    def signature(self) -> tuple:
        return (self.key, self.operator.value, tuple(sorted(self.values)))


def _num(v: str | None):
    try:
        return float(v)  # type: ignore[arg-type]
    except (TypeError, ValueError):
        return None


@dataclass
class Requirements:
    """A conjunction of requirements, deduped per key (AND across keys,
    operator semantics within a key)."""

    items: list[Requirement] = field(default_factory=list)

    @classmethod
    def from_selector(cls, selector: dict[str, str]) -> "Requirements":
        return cls([Requirement(k, Operator.IN, (v,)) for k, v in sorted(selector.items())])

    def add(self, req: Requirement) -> "Requirements":
        self.items.append(req)
        return self

    def merged(self, other: "Requirements") -> "Requirements":
        return Requirements(self.items + other.items)

    def matches(self, labels: dict[str, str]) -> bool:
        return all(r.matches(labels) for r in self.items)

    def allowed_values(self, key: str, candidates: Iterable[str]) -> list[str]:
        """Filter candidate values for ``key`` to those every requirement on
        that key admits."""
        reqs = [r for r in self.items if r.key == key]
        return [c for c in candidates if all(r.allows_value(c) for r in reqs)]

    def has_key(self, key: str) -> bool:
        return any(r.key == key for r in self.items)

    def get(self, key: str) -> list[Requirement]:
        return [r for r in self.items if r.key == key]

    @property
    def signature(self) -> tuple:
        return tuple(sorted(r.signature for r in self.items))

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)
