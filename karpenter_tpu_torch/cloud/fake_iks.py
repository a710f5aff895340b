"""Stateful in-memory fake IKS (managed-cluster) API
(port of ``karpenter_tpu/cloud/fake_iks.py``).

Parity with the reference's IKS double (``pkg/fake/iksapi.go:29-485``):
worker pools with per-zone sizing, **atomic** increment/decrement resize
(the race-free resize idiom of ``pkg/cloudprovider/ibm/iks.go:406``),
worker -> VPC instance mapping, call recording and error injection via the
shared :class:`~karpenter_tpu_torch.cloud.fake.CallRecorder`.

Workers materialize real instances in the attached :class:`FakeCloud`, so
the node-join continuation and GC sweeps behave identically across VPC and
IKS actuation modes.
"""

from __future__ import annotations

import itertools
import threading

from karpenter_tpu_torch.cloud.errors import CloudError, not_found
from karpenter_tpu_torch.cloud.fake import CallRecorder, FakeCloud
from karpenter_tpu_torch.cloud.resources import Worker, WorkerPool

# Historical names — DTOs live in cloud/resources.py, shared with the
# HTTP-backed IKS client.
FakeWorkerPool = WorkerPool
FakeWorker = Worker


class FakeIKS:
    """One fake IKS cluster backed by a FakeCloud for instances."""

    def __init__(self, cluster_id: str, cloud: FakeCloud,
                 kube_version: str = "1.32.3"):
        self.cluster_id = cluster_id
        self.cloud = cloud
        self.kube_version = kube_version
        self.recorder = CallRecorder()
        self.pools: dict[str, FakeWorkerPool] = {}
        self.workers: dict[str, FakeWorker] = {}
        self._lock = threading.RLock()
        self._pool_seq = itertools.count(1)
        self._worker_seq = itertools.count(1)

    # -- pool CRUD (ref iks.go:317-469, 559-633) ---------------------------

    def list_pools(self) -> list[FakeWorkerPool]:
        self.recorder.record("list_pools")
        self.recorder.maybe_raise("list_pools")
        with self._lock:
            return list(self.pools.values())

    def get_pool(self, pool_id: str) -> FakeWorkerPool:
        self.recorder.record("get_pool", pool_id)
        self.recorder.maybe_raise("get_pool")
        with self._lock:
            pool = self.pools.get(pool_id)
            if pool is None:
                raise not_found("worker_pool", pool_id)
            return pool

    def get_pool_by_name(self, name: str) -> FakeWorkerPool | None:
        with self._lock:
            for pool in self.pools.values():
                if pool.name == name:
                    return pool
        return None

    def create_pool(self, name: str, flavor: str, zones: list[str],
                    size_per_zone: int = 0, labels: dict[str, str] | None = None,
                    dynamic: bool = False) -> FakeWorkerPool:
        self.recorder.record("create_pool", name, flavor)
        self.recorder.maybe_raise("create_pool")
        with self._lock:
            if self.get_pool_by_name(name) is not None:
                raise CloudError(f"worker pool {name!r} already exists", 409,
                                 code="already_exists", retryable=False)
            pool = FakeWorkerPool(
                id=f"pool-{next(self._pool_seq)}", name=name, flavor=flavor,
                zones=list(zones), size_per_zone=size_per_zone,
                labels=dict(labels or {}), dynamic=dynamic)
            self.pools[pool.id] = pool
            for zone in pool.zones:
                for _ in range(size_per_zone):
                    self._add_worker_locked(pool, zone)
            return pool

    def delete_pool(self, pool_id: str) -> None:
        self.recorder.record("delete_pool", pool_id)
        self.recorder.maybe_raise("delete_pool")
        with self._lock:
            pool = self.pools.get(pool_id)
            if pool is None:
                raise not_found("worker_pool", pool_id)
            for worker in [w for w in self.workers.values()
                           if w.pool_id == pool_id]:
                self._remove_worker_locked(worker)
            del self.pools[pool_id]

    def add_pool_zone(self, pool_id: str, zone: str) -> None:
        """Idempotently extend a pool's zone list (locked — callers must
        not check-then-append on the pool object directly)."""
        self.recorder.record("add_pool_zone", pool_id, zone)
        self.recorder.maybe_raise("add_pool_zone")
        with self._lock:
            pool = self.pools.get(pool_id)
            if pool is None:
                raise not_found("worker_pool", pool_id)
            if zone not in pool.zones:
                pool.zones.append(zone)

    # -- atomic resize (ref iks.go:406 atomic increment) -------------------

    def increment_pool(self, pool_id: str, zone: str) -> FakeWorker:
        """Atomically grow the pool by one worker in ``zone`` and return the
        new worker — callers never read-modify-write a size field, so
        concurrent increments can't lose updates."""
        self.recorder.record("increment_pool", pool_id, zone)
        self.recorder.maybe_raise("increment_pool")
        with self._lock:
            pool = self.pools.get(pool_id)
            if pool is None:
                raise not_found("worker_pool", pool_id)
            if zone not in pool.zones:
                raise CloudError(f"pool {pool.name} has no zone {zone}", 400,
                                 code="bad_request", retryable=False)
            worker = self._add_worker_locked(pool, zone)
            pool.size_per_zone = max(
                len([w for w in self.workers.values()
                     if w.pool_id == pool_id and w.zone == z])
                for z in pool.zones)
            return worker

    def decrement_pool(self, pool_id: str, worker_id: str) -> None:
        """Atomically remove one specific worker."""
        self.recorder.record("decrement_pool", pool_id, worker_id)
        self.recorder.maybe_raise("decrement_pool")
        with self._lock:
            worker = self.workers.get(worker_id)
            if worker is None or worker.pool_id != pool_id:
                raise not_found("worker", worker_id)
            self._remove_worker_locked(worker)
            pool = self.pools.get(pool_id)
            if pool is not None and pool.zones:
                pool.size_per_zone = max(
                    len([w for w in self.workers.values()
                         if w.pool_id == pool_id and w.zone == z])
                    for z in pool.zones)

    # -- workers (ref iks.go:161-232) --------------------------------------

    def list_workers(self, pool_id: str | None = None) -> list[FakeWorker]:
        self.recorder.record("list_workers")
        self.recorder.maybe_raise("list_workers")
        with self._lock:
            return [w for w in self.workers.values()
                    if pool_id is None or w.pool_id == pool_id]

    def get_worker(self, worker_id: str) -> FakeWorker:
        self.recorder.record("get_worker", worker_id)
        self.recorder.maybe_raise("get_worker")
        with self._lock:
            worker = self.workers.get(worker_id)
            if worker is None:
                raise not_found("worker", worker_id)
            return worker

    def worker_instance_id(self, worker_id: str) -> str:
        """Worker -> VPC instance mapping (ref iks.go:195)."""
        return self.get_worker(worker_id).instance_id

    def register_worker(self, instance_id: str, pool_id: str = "") -> FakeWorker:
        """IKS-API bootstrap: register an EXISTING VPC instance as a
        cluster worker (ref AddWorkerToIKSCluster, iks_api.go:53) — the
        control plane joins the node, no cloud-init token dance."""
        self.recorder.record("register_worker", instance_id, pool_id)
        self.recorder.maybe_raise("register_worker")
        inst = self.cloud.get_instance(instance_id)
        with self._lock:
            if pool_id and pool_id not in self.pools:
                raise not_found("worker_pool", pool_id)
            worker = FakeWorker(id=f"worker-{inst.id}", pool_id=pool_id,
                                zone=inst.zone, instance_id=inst.id)
            self.workers[worker.id] = worker
            return worker

    def get_cluster_config(self) -> dict:
        """Cluster config for bootstrap decisions (ref iks.go:248)."""
        self.recorder.record("get_cluster_config")
        self.recorder.maybe_raise("get_cluster_config")
        return {"cluster_id": self.cluster_id,
                "kube_version": self.kube_version,
                "api_endpoint": f"https://{self.cluster_id}.cluster.local:6443",
                "ca_bundle": "fake-ca"}

    def deploy_worker(self, worker_id: str) -> None:
        """Test hook: worker finishes provisioning."""
        with self._lock:
            if worker_id in self.workers:
                self.workers[worker_id].state = "deployed"

    # -- internals ---------------------------------------------------------

    def _add_worker_locked(self, pool: FakeWorkerPool, zone: str) -> FakeWorker:
        # caller holds self._lock (RLock; the _locked contract)
        subnet = next((s for s in self.cloud.list_subnets() if s.zone == zone),
                      None)
        images = self.cloud.list_images()   # IKS-managed worker image
        inst = self.cloud.create_instance(
            name=f"iks-{pool.name}-{next(self._worker_seq)}",
            profile=pool.flavor, zone=zone,
            subnet_id=subnet.id if subnet else "",
            image_id=images[0].id if images else "",
            tags={"iks.io/cluster": self.cluster_id,
                  "iks.io/pool": pool.id})
        worker = FakeWorker(id=f"worker-{inst.id}", pool_id=pool.id,
                            zone=zone, instance_id=inst.id)
        self.workers[worker.id] = worker
        return worker

    def _remove_worker_locked(self, worker: FakeWorker) -> None:
        # caller holds self._lock (RLock; the _locked contract)
        try:
            self.cloud.delete_instance(worker.instance_id)
        except CloudError:
            pass
        self.workers.pop(worker.id, None)
