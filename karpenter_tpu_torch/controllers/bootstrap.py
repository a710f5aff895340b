"""Bootstrap-token controller.

Parity with the reference's ``pkg/controllers/bootstrap/token_controller.go``:

- ensures the RBAC objects that let TLS-bootstrapping kubelets join exist
  (csr auto-approval bindings, token-authentication group binding —
  token_controller.go:91),
- sweeps expired bootstrap tokens (:190),
- pre-mints a fresh token when none has useful life left (:228), so node
  creation never stalls on token creation in the hot provisioning path.

The reference watches kube-system Secrets; here tokens live in the
in-memory :class:`~karpenter_tpu_torch.core.bootstrap.TokenStore` and RBAC is
modeled as ClusterState objects (kind ``rbac``), which the fake admission
layer and tests can assert on.

(Copy of ``karpenter_tpu/controllers/bootstrap.py``.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from karpenter_tpu_torch.controllers.runtime import PollController, Result
from karpenter_tpu_torch.core.bootstrap import TokenStore
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("controllers.bootstrap")

# (ref token_controller.go:91-160 — the bindings created on boot)
REQUIRED_BINDINGS = (
    ("karpenter:bootstrap:auto-approve-csr",
     "system:bootstrappers:karpenter:default-node-token",
     "system:certificates.k8s.io:certificatesigningrequests:nodeclient"),
    ("karpenter:bootstrap:auto-approve-renewals",
     "system:nodes",
     "system:certificates.k8s.io:certificatesigningrequests:selfnodeclient"),
    ("karpenter:bootstrap:node-bootstrapper",
     "system:bootstrappers:karpenter:default-node-token",
     "system:node-bootstrapper"),
)


@dataclass
class RBACBinding:
    name: str
    subject_group: str
    role: str
    labels: dict[str, str] = field(default_factory=dict)


class BootstrapTokenController(PollController):
    """Singleton poller (the reference is secret-watch-driven; the token
    set here is process-local, so a 5-minute sweep gives the same
    guarantees)."""

    name = "bootstrap.token"
    interval = 300.0

    # mint a replacement when the freshest token has < this much life —
    # matches TokenStore.find_or_create's reuse threshold so provisioning
    # never needs to mint inline (token.go:85 find-unexpired contract)
    MIN_TOKEN_LIFE = 6 * 3600.0

    def __init__(self, cluster: ClusterState, tokens: TokenStore):
        self.cluster = cluster
        self.tokens = tokens

    def reconcile(self) -> Result:
        self._ensure_rbac()
        removed = self.tokens.cleanup_expired()
        if removed:
            log.info("expired bootstrap tokens removed", count=removed)
        live = self.tokens.live_tokens()
        now = self.tokens._clock()
        if not any(t.expires_at - now > self.MIN_TOKEN_LIFE for t in live):
            t = self.tokens.find_or_create()
            log.info("bootstrap token minted", token_id=t.token_id)
        return Result()

    def _ensure_rbac(self) -> None:
        for name, group, role in REQUIRED_BINDINGS:
            if self.cluster.get("rbac", name) is None:
                self.cluster.add("rbac", name, RBACBinding(
                    name=name, subject_group=group, role=role,
                    labels={"app.kubernetes.io/managed-by": "karpenter-tpu"}))
                log.info("rbac binding ensured", name=name, role=role)

    def missing_bindings(self) -> list[str]:
        return [n for n, _, _ in REQUIRED_BINDINGS
                if self.cluster.get("rbac", n) is None]
