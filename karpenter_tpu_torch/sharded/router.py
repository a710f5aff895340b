"""Streaming admission front-end: hash pods to shards, own the map (port
of ``karpenter_tpu/sharded/router.py``).

The router is the only place shard ownership lives.  Pods route by their
constraint-signature key (``PodSpec.signature_key``, the grouping the
encoder applies), so a solve group never splits across shards; group
ownership is the unit a rebalance migrates.  The default placement is a
content hash (blake2b of the signature's repr, the reference's digest,
so both packages partition a window identically in every process);
migrations override it through :meth:`ShardRouter.migrate`, and the
override map is the state the sharded checks re-derive placement from.
"""

from __future__ import annotations

import hashlib
import threading

from karpenter_tpu_torch.apis.pod import PodSpec, ResourceRequests


def signature_key(pod: PodSpec) -> str:
    """Stable string form of the pod's constraint signature (identical
    signature => identical key on every host, in every process)."""
    return pod.signature_key()


def stable_shard(key: str, num_shards: int) -> int:
    """Content-hash shard placement: blake2b, not ``hash()`` (which is
    salted per process: a restart would re-shard the whole fleet)."""
    digest = hashlib.blake2b(key.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") % num_shards


def craft_hot_requests(shards: int, shard: int = 0, *, cpu: int = 100,
                       mem: int = 512, count: int = 1,
                       limit: int = 4096) -> list[tuple[int, int]]:
    """``count`` distinct (cpu, mem) request sizes whose constraint
    signatures all hash onto ``shard``: the hash-skewed workload.  Scans
    cpu upward from ``cpu``; raises if ``limit`` probes cannot satisfy
    ``count``."""
    out: list[tuple[int, int]] = []
    for k in range(limit):
        probe = PodSpec("hot-probe",
                        requests=ResourceRequests(cpu + k, mem, 0, 1))
        if stable_shard(signature_key(probe), shards) == shard:
            out.append((cpu + k, mem))
            if len(out) == count:
                return out
    raise ValueError(f"could not craft {count} hot requests within "
                     f"{limit} probes")


class ShardRouter:
    """Deterministic pod -> shard placement with migratable ownership."""

    def __init__(self, num_shards: int):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        self._lock = threading.Lock()
        # signature key -> shard override (rebalance migrations); absent
        # keys fall back to the stable hash
        self._owner: dict[str, int] = {}
        # affinity components: signature key -> the full member tuple of
        # its component.  Members co-route to one shard and migrate
        # whole (a split component would hide inter-group edges from
        # both shards' solves).
        self._components: dict[str, tuple[str, ...]] = {}
        self.migrations = 0
        self.components_bound = 0

    def shard_of(self, pod: PodSpec) -> int:
        return self.shard_of_key(signature_key(pod))

    def shard_of_key(self, key: str) -> int:
        with self._lock:
            return self.shard_of_key_locked(key)

    def shard_of_key_locked(self, key: str) -> int:
        s = self._owner.get(key)
        return s if s is not None else stable_shard(key, self.num_shards)

    def partition(self, pods) -> list[list[PodSpec]]:
        """Disjoint cover of ``pods`` across shards, input order kept
        within each shard (the order the per-shard encode sees)."""
        parts: list[list[PodSpec]] = [[] for _ in range(self.num_shards)]
        for p in pods:
            parts[self.shard_of(p)].append(p)
        return parts

    def bind_components(self, pods) -> int:
        """Co-route affinity components: every signature group linked by
        an armed inter-group (anti-)affinity edge or a shared bounded
        spread class lands on the home shard of the lexicographically
        smallest member key, through the override map migrations use.
        Edge-free windows are a no-op.  Returns the number of
        multi-group components bound."""
        from karpenter_tpu_torch.affinity.encode import build_affinity_index

        by_sig: dict[str, PodSpec] = {}
        for p in pods:
            by_sig.setdefault(signature_key(p), p)
        keys = list(by_sig)
        idx = build_affinity_index([by_sig[k] for k in keys])
        if idx is None:
            return 0
        comps: dict[int, list[str]] = {}
        for i, k in enumerate(keys):
            comps.setdefault(int(idx.comp[i]), []).append(k)
        bound = 0
        with self._lock:
            for root in sorted(comps):
                members = sorted(comps[root])
                if len(members) < 2:
                    continue
                dst = self.shard_of_key_locked(members[0])
                mt = tuple(members)
                for k in members:
                    self._components[k] = mt
                    self._set_owner_locked(k, dst)
                bound += 1
            self.components_bound += bound
        return bound

    def _set_owner_locked(self, key: str, dst: int) -> None:
        if self.shard_of_key_locked(key) == dst:
            return
        if stable_shard(key, self.num_shards) == dst:
            # routing back home: drop the override (the map stays
            # minimal)
            self._owner.pop(key, None)
        else:
            self._owner[key] = dst

    def migrate(self, key: str, dst: int) -> bool:
        """Move ownership of one signature group (of its whole component
        when bound) to ``dst``.  Returns False for a no-op."""
        if not 0 <= dst < self.num_shards:
            raise ValueError(f"shard {dst} out of range "
                             f"[0, {self.num_shards})")
        with self._lock:
            members = self._components.get(key, (key,))
            if all(self.shard_of_key_locked(k) == dst for k in members):
                return False
            for k in members:
                self._set_owner_locked(k, dst)
            self.migrations += 1
            return True

    def component_of(self, key: str) -> tuple[str, ...]:
        """The bound component containing ``key`` (a singleton tuple for
        unbound keys), the unit every migration moves."""
        with self._lock:
            return self._components.get(key, (key,))

    def overrides(self) -> dict[str, int]:
        with self._lock:
            return dict(self._owner)

    def stats(self) -> dict:
        with self._lock:
            return {"shards": self.num_shards,
                    "overrides": len(self._owner),
                    "migrations": self.migrations,
                    "components": len(set(self._components.values())),
                    "components_bound": self.components_bound}
