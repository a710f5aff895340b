"""In-memory cluster state: the K8s-API-server analogue.

The reference keeps ALL durable state in the K8s API (SURVEY.md §5.4) and
controllers watch/list/patch it through controller-runtime.  This module is
the standalone framework's equivalent: a thread-safe typed object store
with

- per-kind collections (pods, nodes, nodeclaims, nodeclasses, nodepools);
- monotonically increasing resource versions + optimistic-concurrency
  ``update`` (mirrors the status controller's optimistic-lock patches,
  autoplacement/controller.go:248-250);
- watch callbacks (ADDED/MODIFIED/DELETED) feeding watch-driven
  controllers and the provisioner's pending-pod intake;
- an events sink (the record.EventRecorder analogue,
  pkg/cloudprovider/events).

Controller restart = resume: rebuild this store from whatever the real
durable backend is; caches and solver state are derived (§5.4 parity).

(Copy of ``karpenter_tpu/core/cluster.py``.)
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from collections.abc import Callable
from typing import Any

from karpenter_tpu_torch.apis.nodeclaim import Node, NodeClaim, NodePool
from karpenter_tpu_torch.apis.nodeclass import NodeClass
from karpenter_tpu_torch.apis.pod import PodSpec
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("core.cluster")

ADDED, MODIFIED, DELETED = "ADDED", "MODIFIED", "DELETED"


class ConflictError(Exception):
    """Optimistic-concurrency conflict (stale resourceVersion)."""


@dataclass
class Event:
    """A recorded cluster event (the K8s Event analogue)."""

    kind: str
    name: str
    type: str          # Normal | Warning
    reason: str
    message: str
    timestamp: float = field(default_factory=time.time)


@dataclass
class PendingPod:
    """A pod awaiting scheduling, tracked with its nomination state."""

    spec: PodSpec
    enqueued_at: float = field(default_factory=time.time)
    nominated_node: str = ""       # set once a plan assigns it
    bound_node: str = ""           # set when "scheduled"


class _Collection:
    def __init__(self, store: "ClusterState", kind: str):
        self._store = store
        self._kind = kind
        self._items: dict[str, Any] = {}

    def __len__(self):
        with self._store._lock:
            return len(self._items)


class ClusterState:
    def __init__(self):
        self._lock = threading.RLock()
        self._rv = 0
        self._collections: dict[str, dict[str, Any]] = defaultdict(dict)
        for kind in ("pods", "nodes", "nodeclaims", "nodeclasses",
                     "nodepools", "lbregistrations", "rbac"):
            self._collections[kind] = {}
        self._watchers: dict[str, list[Callable[[str, Any], None]]] = defaultdict(list)
        self.events: list[Event] = []

    # -- generic store -----------------------------------------------------

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    def add(self, kind: str, name: str, obj: Any) -> Any:
        with self._lock:
            coll = self._collections[kind]
            if name in coll:
                raise ConflictError(f"{kind}/{name} already exists")
            if hasattr(obj, "resource_version"):
                obj.resource_version = self._next_rv()
            coll[name] = obj
            watchers = list(self._watchers[kind])
        self._notify(watchers, ADDED, obj)
        return obj

    def get(self, kind: str, name: str) -> Any | None:
        with self._lock:
            return self._collections[kind].get(name)

    def list(self, kind: str, predicate: Callable[[Any], bool] | None = None) -> list[Any]:
        with self._lock:
            items = list(self._collections[kind].values())
        return [i for i in items if predicate(i)] if predicate else items

    def update(self, kind: str, name: str, obj: Any,
               expect_rv: int | None = None) -> Any:
        with self._lock:
            coll = self._collections[kind]
            current = coll.get(name)
            if current is None:
                raise ConflictError(f"{kind}/{name} does not exist")
            if expect_rv is not None and \
                    getattr(current, "resource_version", None) != expect_rv:
                raise ConflictError(
                    f"{kind}/{name}: stale resourceVersion "
                    f"{expect_rv} != {current.resource_version}")
            if hasattr(obj, "resource_version"):
                obj.resource_version = self._next_rv()
            coll[name] = obj
            watchers = list(self._watchers[kind])
        self._notify(watchers, MODIFIED, obj)
        return obj

    def delete(self, kind: str, name: str) -> Any | None:
        with self._lock:
            obj = self._collections[kind].pop(name, None)
            watchers = list(self._watchers[kind]) if obj is not None else []
        if obj is not None:
            self._notify(watchers, DELETED, obj)
        return obj

    def watch(self, kind: str, callback: Callable[[str, Any], None]) -> Callable[[], None]:
        """Register a watch callback; returns an unsubscribe function."""
        with self._lock:
            self._watchers[kind].append(callback)

        def unsubscribe():
            with self._lock:
                try:
                    self._watchers[kind].remove(callback)
                except ValueError:
                    pass
        return unsubscribe

    def _notify(self, watchers, event_type: str, obj: Any) -> None:
        for cb in watchers:
            try:
                cb(event_type, obj)
            except Exception as e:  # watchers must not break the store
                log.error("watch callback failed", error=str(e))

    # -- events ------------------------------------------------------------

    def record_event(self, kind: str, name: str, type_: str, reason: str,
                     message: str) -> None:
        with self._lock:
            self.events.append(Event(kind, name, type_, reason, message))
            if len(self.events) > 10000:
                self.events = self.events[-5000:]

    def events_for(self, kind: str, name: str) -> list[Event]:
        with self._lock:
            return [e for e in self.events if e.kind == kind and e.name == name]

    # -- typed conveniences ------------------------------------------------

    def add_nodeclass(self, nc: NodeClass) -> NodeClass:
        """Admission-validates the spec (the webhook analogue — ref
        ibmnodeclass_webhook.go + the CEL rules of
        ibmnodeclass_types.go:481-488); deep cloud checks stay with the
        status controller."""
        errs = nc.validate()
        if errs:
            from karpenter_tpu_torch.apis.nodeclass import ValidationError

            raise ValidationError(
                f"nodeclass {nc.name} rejected at admission: {errs[:3]}")
        return self.add("nodeclasses", nc.name, nc)

    def get_nodeclass(self, name: str) -> NodeClass | None:
        return self.get("nodeclasses", name)

    def add_nodepool(self, np_: NodePool) -> NodePool:
        return self.add("nodepools", np_.name, np_)

    def add_pod(self, pod: PodSpec) -> PendingPod:
        key = f"{pod.namespace}/{pod.name}"
        # the pod's placement clock starts HERE — this is the API-server
        # intake every path (operator watch, chaos harness, tests) shares,
        # so the SLO ledger's first-seen stamp cannot miss an entry point
        ledger = obs.get_ledger()
        ledger.first_seen(key)
        # arrival-history stamp (whatif/forecast.py): the signature-group
        # key is the encoder's grouping, so forecasted waves line up with
        # baseline solve groups exactly
        ledger.arrival(pod.signature_key())
        return self.add("pods", key, PendingPod(spec=pod))

    def pending_pods(self) -> list[PendingPod]:
        return self.list("pods", lambda p: not p.bound_node)

    def evict_node_pods(self, node_name: str) -> int:
        """Re-pend every pod bound/nominated to ``node_name``'s claim —
        the node-lifecycle eviction that follows a Node deletion in a
        real cluster (without it, pods bound to a dead node would strand
        forever in the sim)."""
        if not node_name:
            return 0
        n = 0
        with self._lock:
            pods = list(self._collections["pods"].values())
        for pending in pods:
            if pending.bound_node == node_name or \
                    pending.nominated_node == node_name:
                pending.bound_node = ""
                pending.nominated_node = ""
                pending.enqueued_at = 0.0   # immediate re-window
                n += 1
        return n

    def bind_pod(self, pod_key: str, node_name: str) -> None:
        with self._lock:
            p = self._collections["pods"].get(pod_key)
            if p is not None:
                p.bound_node = node_name
        obs.get_ledger().stamp(pod_key, "bound", dedupe=True)

    def add_nodeclaim(self, claim: NodeClaim) -> NodeClaim:
        return self.add("nodeclaims", claim.name, claim)

    def get_nodeclaim(self, name: str) -> NodeClaim | None:
        return self.get("nodeclaims", name)

    def nodeclaims(self, predicate=None) -> list[NodeClaim]:
        return self.list("nodeclaims", predicate)

    def add_node(self, node: Node) -> Node:
        return self.add("nodes", node.name, node)

    def get_node(self, name: str) -> Node | None:
        return self.get("nodes", name)

    def nodes(self, predicate=None) -> list[Node]:
        return self.list("nodes", predicate)

    def node_count_by_subnet(self) -> dict[str, int]:
        """{subnet_id: node count} for subnet cluster-awareness scoring
        (ref walks providerID -> GetInstance, subnet/provider.go:247-310;
        here claims carry their subnet)."""
        counts: dict[str, int] = defaultdict(int)
        for claim in self.nodeclaims():
            if claim.subnet_id and not claim.deleted:
                counts[claim.subnet_id] += 1
        return dict(counts)
