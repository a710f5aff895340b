"""What-if CLI (`make whatif-determinism`) (port of
``karpenter_tpu/whatif/__main__.py``).

    python -m karpenter_tpu_torch.whatif --determinism [--seeds N]
    python -m karpenter_tpu_torch.whatif --demo

The determinism check is the chaos matrix's discipline applied to the
planning plane: one seeded cycle (seeded arrival ledger -> forecast ->
standing menu -> stacked plan -> recommendation registry) run twice in
one process and the digests compared: the same ledger and seed must give
the same recommendation set.  ``--device`` (default ``cuda``) is where
the stacked plan runs: the card, or ``cpu`` for the plain PyTorch
programs; without a card the default raises.  Exit 1 on any digest
mismatch or validator rejection.
"""

from __future__ import annotations

import argparse
import sys
from types import SimpleNamespace


class _StubCluster:
    """Just enough cluster for PlanningService: a fixed pending set."""

    def __init__(self, pods):
        self._pods = list(pods)

    def pending_pods(self):
        return [SimpleNamespace(spec=p) for p in self._pods]

    def list(self, kind, predicate=None):
        return []

    def get_nodeclass(self, name):
        return None


def _seeded_world(seed: int):
    """(cluster, catalog, ledger-seeding fn): a deterministic pending
    backlog + arrival history keyed only by ``seed``."""
    import random

    from karpenter_tpu_torch.apis.pod import PodSpec, ResourceRequests
    from karpenter_tpu_torch.catalog import (
        CatalogArrays, InstanceTypeProvider, PricingProvider,
    )
    from karpenter_tpu_torch.cloud.fake import FakeCloud, generate_profiles

    rng = random.Random(seed)
    cloud = FakeCloud(profiles=generate_profiles(16))
    pricing = PricingProvider(cloud)
    catalog = CatalogArrays.build(InstanceTypeProvider(cloud,
                                                      pricing).list())
    pricing.close()
    menu = [(100 * rng.randint(1, 8), 256 * rng.randint(1, 8))
            for _ in range(6)]
    pods = [PodSpec(f"whatif-{i}",
                    requests=ResourceRequests(*menu[i % len(menu)], 0, 1))
            for i in range(48)]

    def seed_ledger(ledger):
        r = random.Random(seed * 31)
        for day_hour in range(24):
            for p in pods:
                for _ in range(r.randint(0, 2)):
                    ledger.arrival(p.signature_key(),
                                   t=day_hour * 3600.0)

    return _StubCluster(pods), catalog, seed_ledger


def _one_cycle(seed: int, device="cuda") -> tuple[str, list[str]]:
    """One full planning cycle on a FRESH ledger + service; returns the
    recommendation digest and any validator violations."""
    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.obs.ledger import PlacementLedger
    from karpenter_tpu_torch.whatif.service import PlanningService

    cluster, catalog, seed_ledger = _seeded_world(seed)
    ledger = PlacementLedger()
    seed_ledger(ledger)
    with obs.use_ledger(ledger):
        svc = PlanningService(cluster, catalog_fn=lambda: catalog,
                              seed=seed, validate=True, device=device)
        payload = svc.evaluate(record=True, hour=9)
    violations = payload.get("validation", {}).get("violations", [])
    return svc.digest(), list(violations)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="karpenter_tpu_torch.whatif")
    ap.add_argument("--determinism", action="store_true",
                    help="run each seeded planning cycle twice and "
                         "compare recommendation digests")
    ap.add_argument("--seeds", type=int, default=2,
                    help="seeds 1..N for --determinism (default 2)")
    ap.add_argument("--demo", action="store_true",
                    help="one seeded cycle, print the payload summary")
    ap.add_argument("--device", default="cuda",
                    help="where the stacked plan runs: cuda (default; "
                         "raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.demo:
        digest, violations = _one_cycle(1, args.device)
        print(f"whatif demo: digest={digest[:12]} "
              f"violations={len(violations)}")
        return 1 if violations else 0

    if not args.determinism:
        ap.print_help()
        return 2

    failures = 0
    for seed in range(1, args.seeds + 1):
        d1, v1 = _one_cycle(seed, args.device)
        d2, v2 = _one_cycle(seed, args.device)
        ok = d1 == d2 and not v1 and not v2
        status = "ok  " if ok else "FAIL"
        print(f"{status} whatif-determinism seed={seed} "
              f"digest={d1[:12]} rerun={d2[:12]} "
              f"violations={len(v1) + len(v2)}")
        if not ok:
            failures += 1
            for v in (v1 + v2)[:4]:
                print(f"     {v}")
    if failures:
        print(f"whatif determinism: {failures} seed(s) failed — replay "
              f"with: python -m karpenter_tpu_torch.whatif --determinism "
              f"--seeds {args.seeds} --device {args.device}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
