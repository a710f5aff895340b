"""Fake kubelet: simulates the async node-join continuation.

In the reference, `CreateInstance` returns and the new VM's cloud-init runs
kubelet, which TLS-bootstraps with the token and appears as a Node with the
unregistered NoExecute taint (SURVEY.md §3.2 "[async continuation]").  Tests
and the simulated control loop drive that continuation through this class:
``join(claim)`` materializes the Node exactly as the bootstrap's
``--register-with-taints`` would, ``mark_ready`` flips kubelet Ready.

(Copy of ``karpenter_tpu/core/kubelet.py``.)
"""

from __future__ import annotations

import time

from karpenter_tpu_torch.apis.nodeclaim import Node, NodeClaim
from karpenter_tpu_torch.core.bootstrap import TAINT_UNREGISTERED
from karpenter_tpu_torch.core.cluster import ClusterState


class FakeKubelet:
    def __init__(self, cluster: ClusterState, cloud=None):
        self.cluster = cluster
        self.cloud = cloud

    def join(self, claim: NodeClaim, ready: bool = False) -> Node:
        """The kubelet registers: Node appears with the bootstrap taints
        (claim taints + startup taints + unregistered), NO karpenter labels
        yet — the registration controller syncs those from the claim."""
        node = Node(
            name=claim.name,
            provider_id=claim.provider_id,
            labels={"kubernetes.io/hostname": claim.name},
            taints=(list(claim.taints) + list(claim.startup_taints) +
                    [TAINT_UNREGISTERED]),
            ready=ready,
            conditions={"Ready": "True" if ready else "False"},
            addresses=[f"10.0.0.{abs(hash(claim.name)) % 250 + 1}"])
        return self.cluster.add_node(node)

    def join_pending(self, ready: bool = False) -> list[Node]:
        """Join every launched-but-nodeless claim (the bulk helper), then
        bind nominated pods onto ready nodes — the kube-scheduler's half
        of the continuation."""
        have = {n.provider_id for n in self.cluster.nodes()}
        joined = []
        for claim in self.cluster.nodeclaims():
            if claim.launched and not claim.deleted and \
                    claim.provider_id not in have:
                joined.append(self.join(claim, ready=ready))
        self.bind_nominated()
        return joined

    def bind_nominated(self) -> int:
        """Bind each nominated-but-unbound pod once its claim's node is
        Ready (the kube-scheduler bind the provisioner's nomination
        anticipates).  Pods nominated onto claims whose node joined
        EARLIER — e.g. a repack cutover onto an already-Ready fleet —
        bind here too, not just at join time."""
        n = 0
        for pending in self.cluster.list("pods"):
            if pending.bound_node or not pending.nominated_node:
                continue
            claim = self.cluster.get_nodeclaim(pending.nominated_node)
            if claim is None or claim.deleted:
                continue
            node = self.cluster.get_node(claim.node_name or claim.name)
            if node is None or not node.ready or node.deleted:
                continue
            from karpenter_tpu_torch.apis.pod import pod_key

            self.cluster.bind_pod(pod_key(pending.spec), node.name)
            n += 1
        return n

    def mark_ready(self, node_name: str, ready: bool = True) -> Node | None:
        node = self.cluster.get_node(node_name)
        if node is None:
            return None
        node.ready = ready
        node.conditions["Ready"] = "True" if ready else "False"
        return self.cluster.update("nodes", node_name, node)

    def mark_condition(self, node_name: str, condition: str, status: str,
                       since: float | None = None) -> Node | None:
        node = self.cluster.get_node(node_name)
        if node is None:
            return None
        node.conditions[condition] = status
        if since is not None:
            node.annotations[f"cond-since/{condition}"] = str(since)
        return self.cluster.update("nodes", node_name, node)
