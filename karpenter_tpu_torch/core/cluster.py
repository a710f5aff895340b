"""In-memory cluster state: the part the preemption and repack planes read.

Port of ``karpenter_tpu/core/cluster.py`` restricted to what
``preempt/encode.encode_victims``, ``repack/encode.encode_repack``,
``resident/store.OccupancySnapshot`` and the plans' validators read:
the pod records (bound or nominated node, looked up by key, the pending
ones listed) and the node claims, with resource versions.  Nodes, node pools,
watches, events, optimistic-concurrency updates and the node-class
admission of the reference belong to the controller layer, which this
package does not carry yet; nothing here reads a ``NodeClass``.
"""

from __future__ import annotations

import threading
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.pod import PodSpec, pod_key


class ConflictError(Exception):
    """An object of that kind and name exists already."""


@dataclass
class PendingPod:
    """A pod awaiting scheduling, tracked with its nomination state."""

    spec: PodSpec
    nominated_node: str = ""       # set once a plan assigns it
    bound_node: str = ""           # set when "scheduled"


class ClusterState:
    """Thread-safe typed object store (the API-server analogue)."""

    KINDS = ("pods", "nodeclaims")

    def __init__(self):
        self._lock = threading.RLock()
        self._rv = 0
        self._collections: dict[str, dict[str, Any]] = {
            kind: {} for kind in self.KINDS}

    def add(self, kind: str, name: str, obj: Any) -> Any:
        with self._lock:
            coll = self._collections[kind]
            if name in coll:
                raise ConflictError(f"{kind}/{name} already exists")
            if hasattr(obj, "resource_version"):
                self._rv += 1
                obj.resource_version = self._rv
            coll[name] = obj
        return obj

    def get(self, kind: str, name: str) -> Any | None:
        with self._lock:
            return self._collections[kind].get(name)

    def list(self, kind: str,
             predicate: Callable[[Any], bool] | None = None) -> list[Any]:
        with self._lock:
            items = list(self._collections[kind].values())
        return [i for i in items if predicate(i)] if predicate else items

    def add_pod(self, pod: PodSpec) -> PendingPod:
        return self.add("pods", pod_key(pod), PendingPod(spec=pod))

    def pending_pods(self) -> list[PendingPod]:
        return self.list("pods", lambda p: not p.bound_node)

    def bind_pod(self, key: str, node_name: str) -> None:
        with self._lock:
            p = self._collections["pods"].get(key)
            if p is not None:
                p.bound_node = node_name

    def add_nodeclaim(self, claim: NodeClaim) -> NodeClaim:
        return self.add("nodeclaims", claim.name, claim)

    def nodeclaims(self, predicate=None) -> list[NodeClaim]:
        return self.list("nodeclaims", predicate)
