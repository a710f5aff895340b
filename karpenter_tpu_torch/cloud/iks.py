"""HTTP-backed IKS (managed-cluster) client — real counterpart to FakeIKS
(port of ``karpenter_tpu/cloud/iks.py``).

Capability parity with ``pkg/cloudprovider/ibm/iks.go:56`` (worker
details :161, worker->VPC instance mapping :195, cluster kubeconfig :248,
pool list/resize with **atomic increment/decrement** :317-469, pool
create/delete :559-633) and the IKS-API bootstrap flow of
``pkg/providers/iks/bootstrap/iks_api.go:53`` (``AddWorkerToIKSCluster`` +
cluster-config retrieval).

Same provider-facing surface as :class:`~karpenter_tpu_torch.cloud.fake_iks.FakeIKS`
(minus the ``deploy_worker`` test hook), so the worker-pool actuator runs
unmodified against either implementation.

Wire protocol (v2-flavored; the stub server in ``cloud/stub.py`` speaks it):

=====================================================  ======================
``GET    /v2/clusters/{c}/workerpools``                list pools
``POST   /v2/clusters/{c}/workerpools``                create pool
``GET    /v2/clusters/{c}/workerpools/{p}``            get pool
``DELETE /v2/clusters/{c}/workerpools/{p}``            delete pool
``POST   /v2/clusters/{c}/workerpools/{p}/zones``      add zone
``POST   /v2/clusters/{c}/workerpools/{p}/increment``  atomic +1 -> worker
``POST   /v2/clusters/{c}/workerpools/{p}/decrement``  atomic -1 (by worker)
``GET    /v2/clusters/{c}/workers[?pool=]``            list workers
``GET    /v2/clusters/{c}/workers/{id}``               get worker
``POST   /v2/clusters/{c}/workers``                    register an existing
                                                       VPC instance as a
                                                       worker (iks_api.go:53)
``GET    /v2/clusters/{c}/config``                     cluster config (API
                                                       endpoint, CA, version)
=====================================================  ======================
"""

from __future__ import annotations


from karpenter_tpu_torch.cloud.http import HTTPClient, TokenSource
from karpenter_tpu_torch.cloud.resources import Worker, WorkerPool


def pool_to_json(p: WorkerPool) -> dict:
    return {"id": p.id, "name": p.name, "flavor": p.flavor,
            "zones": list(p.zones), "size_per_zone": p.size_per_zone,
            "state": p.state, "labels": dict(p.labels),
            "dynamic": p.dynamic, "created_at": p.created_at}


def pool_from_json(d: dict) -> WorkerPool:
    return WorkerPool(
        id=d["id"], name=d.get("name", ""), flavor=d.get("flavor", ""),
        zones=list(d.get("zones") or []),
        size_per_zone=int(d.get("size_per_zone", 0)),
        state=d.get("state", "normal"), labels=dict(d.get("labels") or {}),
        dynamic=bool(d.get("dynamic", False)),
        created_at=float(d.get("created_at", 0.0)))


def worker_to_json(w: Worker) -> dict:
    return {"id": w.id, "pool_id": w.pool_id, "zone": w.zone,
            "instance_id": w.instance_id, "state": w.state}


def worker_from_json(d: dict) -> Worker:
    return Worker(id=d["id"], pool_id=d.get("pool_id", ""),
                  zone=d.get("zone", ""),
                  instance_id=d.get("instance_id", ""),
                  state=d.get("state", "provisioning"))


class IKSClient:
    """Provider-facing IKS client speaking the REST protocol above."""

    def __init__(self, endpoint: str, cluster_id: str, api_key: str = "",
                 token_source: TokenSource | None = None,
                 timeout: float = 30.0, opener=None, sleep=None):
        self.cluster_id = cluster_id
        kw = {}
        if opener is not None:
            kw["opener"] = opener
        if sleep is not None:
            kw["sleep"] = sleep
        tokens = token_source
        if tokens is None and api_key:
            iam = HTTPClient(endpoint, "iam", timeout=timeout, **kw)
            tokens = TokenSource(lambda: iam.post(
                "/identity/token", {"apikey": api_key}, operation="token"))
        self.http = HTTPClient(endpoint, "iks", token_source=tokens,
                               timeout=timeout, **kw)
        self._base = f"/v2/clusters/{cluster_id}"

    # -- pool CRUD (ref iks.go:317-469, 559-633) ---------------------------

    def list_pools(self) -> list[WorkerPool]:
        data = self.http.get(f"{self._base}/workerpools", "list_pools")
        return [pool_from_json(p) for p in data.get("workerpools", [])]

    def get_pool(self, pool_id: str) -> WorkerPool:
        return pool_from_json(self.http.get(
            f"{self._base}/workerpools/{pool_id}", "get_pool"))

    def get_pool_by_name(self, name: str) -> WorkerPool | None:
        for pool in self.list_pools():
            if pool.name == name:
                return pool
        return None

    def create_pool(self, name: str, flavor: str, zones: list[str],
                    size_per_zone: int = 0,
                    labels: dict[str, str] | None = None,
                    dynamic: bool = False) -> WorkerPool:
        body = {"name": name, "flavor": flavor, "zones": list(zones),
                "size_per_zone": size_per_zone, "labels": dict(labels or {}),
                "dynamic": dynamic}
        return pool_from_json(self.http.post(
            f"{self._base}/workerpools", body, "create_pool"))

    def delete_pool(self, pool_id: str) -> None:
        self.http.delete(f"{self._base}/workerpools/{pool_id}", "delete_pool")

    def add_pool_zone(self, pool_id: str, zone: str) -> None:
        self.http.post(f"{self._base}/workerpools/{pool_id}/zones",
                       {"zone": zone}, "add_pool_zone")

    # -- atomic resize (ref iks.go:406) ------------------------------------

    def increment_pool(self, pool_id: str, zone: str) -> Worker:
        """Server-side atomic +1: callers never read-modify-write a size
        field, so concurrent increments cannot lose updates."""
        return worker_from_json(self.http.post(
            f"{self._base}/workerpools/{pool_id}/increment",
            {"zone": zone}, "increment_pool"))

    def decrement_pool(self, pool_id: str, worker_id: str) -> None:
        self.http.post(f"{self._base}/workerpools/{pool_id}/decrement",
                       {"worker_id": worker_id}, "decrement_pool")

    # -- workers (ref iks.go:161-232) --------------------------------------

    def list_workers(self, pool_id: str | None = None) -> list[Worker]:
        path = f"{self._base}/workers"
        if pool_id:
            path += f"?pool={pool_id}"
        data = self.http.get(path, "list_workers")
        return [worker_from_json(w) for w in data.get("workers", [])]

    def get_worker(self, worker_id: str) -> Worker:
        return worker_from_json(self.http.get(
            f"{self._base}/workers/{worker_id}", "get_worker"))

    def worker_instance_id(self, worker_id: str) -> str:
        """Worker -> VPC instance mapping (ref iks.go:195)."""
        return self.get_worker(worker_id).instance_id

    # -- IKS-API bootstrap (ref iks_api.go:53) -----------------------------

    def register_worker(self, instance_id: str,
                        pool_id: str = "") -> Worker:
        """Register an existing VPC instance as a cluster worker — the
        ``AddWorkerToIKSCluster`` flow: the IKS control plane installs the
        kubelet and joins the node, no cloud-init token dance required."""
        body = {"instance_id": instance_id}
        if pool_id:
            body["pool_id"] = pool_id
        return worker_from_json(self.http.post(
            f"{self._base}/workers", body, "register_worker"))

    def get_cluster_config(self) -> dict:
        """Cluster config for bootstrap decisions (ref iks.go:248 cluster
        kubeconfig retrieval): API endpoint, CA bundle, kube version."""
        return self.http.get(f"{self._base}/config", "get_cluster_config")
