"""Subnet provider: listing, scoring, placement-strategy selection.

Parity with ``pkg/providers/vpc/subnet/provider.go``:
- 5-minute list cache (:73-80, :346-414);
- score = available-IP ratio x100 - fragmentation x50 (:95-111);
- cluster-awareness bonus: +50 for subnets already hosting cluster nodes,
  +10 per node (capped), -5 for non-cluster subnets when cluster subnets
  exist (:327-344);
- zone distribution: Balanced = best per zone, AvailabilityFirst = all,
  CostOptimized = top 2 zones (:181-210).

(Copy of ``karpenter_tpu/cloud/subnet.py``.)
"""

from __future__ import annotations

from dataclasses import dataclass
from collections.abc import Callable

from karpenter_tpu_torch.apis.nodeclass import PlacementStrategy, SubnetSelectionCriteria
from karpenter_tpu_torch.cloud.fake import FakeSubnet
from karpenter_tpu_torch.utils.cache import TTLCache
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("cloud.subnet")


def subnet_score(subnet: FakeSubnet) -> float:
    """Higher is better (subnet/provider.go:95-111)."""
    if subnet.total_ips == 0:
        return 0.0
    capacity_ratio = subnet.available_ips / subnet.total_ips
    fragmentation = (subnet.total_ips - subnet.available_ips) / subnet.total_ips
    return capacity_ratio * 100.0 - fragmentation * 50.0


def apply_cluster_awareness(subnet: FakeSubnet, base: float,
                            cluster_subnets: dict[str, int]) -> float:
    """(subnet/provider.go:327-344)"""
    if not cluster_subnets:
        return base
    nodes = cluster_subnets.get(subnet.id, 0)
    if nodes > 0:
        return base + 50.0 + min(nodes * 10.0, 50.0)
    return base - 5.0


class SubnetProvider:
    CACHE_TTL = 300.0  # 5 min (:73-80)

    def __init__(self, client, cluster_subnets_fn: Callable[[], dict[str, int]] | None = None,
                 clock=None):
        """``cluster_subnets_fn`` returns {subnet_id: node_count} for nodes
        already in the cluster (ref walks providerID -> GetInstance,
        :247-310; here the cluster state supplies it directly)."""
        self._client = client
        self._cluster_subnets_fn = cluster_subnets_fn or (lambda: {})
        self._cache = TTLCache(default_ttl=self.CACHE_TTL,
                               **({"clock": clock} if clock else {}))

    def list_subnets(self) -> list[FakeSubnet]:
        return self._cache.get_or_set("subnets", self._client.list_subnets)

    def get_subnet(self, subnet_id: str) -> FakeSubnet:
        return self._client.get_subnet(subnet_id)

    def invalidate(self) -> None:
        self._cache.delete("subnets")

    def select_subnets(self, strategy: PlacementStrategy | None) -> list[FakeSubnet]:
        """Filter -> score -> zone-distribute (:114-217)."""
        strategy = strategy or PlacementStrategy()
        criteria = strategy.subnet_selection or SubnetSelectionCriteria()
        eligible = []
        for s in self.list_subnets():
            if s.state != "available":
                continue
            if criteria.minimum_available_ips > 0 and \
                    s.available_ips < criteria.minimum_available_ips:
                continue
            if criteria.required_tags:
                if any(s.tags.get(k) != v for k, v in criteria.required_tags):
                    continue
            eligible.append(s)
        if not eligible:
            raise ValueError("no eligible subnets found")

        cluster_subnets = self._cluster_subnets_fn()
        scored = sorted(
            eligible,
            key=lambda s: apply_cluster_awareness(s, subnet_score(s), cluster_subnets),
            reverse=True)

        selected: list[FakeSubnet] = []
        seen_zones = set()
        if strategy.zone_balance == "Balanced":
            for s in scored:
                if s.zone not in seen_zones:
                    selected.append(s)
                    seen_zones.add(s.zone)
        elif strategy.zone_balance == "AvailabilityFirst":
            selected = scored
        elif strategy.zone_balance == "CostOptimized":
            for s in scored:
                if len(selected) >= 2:
                    break
                if s.zone not in seen_zones:
                    selected.append(s)
                    seen_zones.add(s.zone)
        else:
            raise ValueError(f"unknown zone balance {strategy.zone_balance!r}")
        if not selected:
            raise ValueError("no subnets selected after applying placement strategy")
        return selected

    def best_subnet_in_zone(self, zone: str) -> FakeSubnet | None:
        """Most-free-IPs subnet in a zone (ref create-path fallback,
        vpc/instance/provider.go:243-329)."""
        candidates = [s for s in self.list_subnets()
                      if s.zone == zone and s.state == "available" and s.available_ips > 0]
        return max(candidates, key=lambda s: s.available_ips, default=None)
