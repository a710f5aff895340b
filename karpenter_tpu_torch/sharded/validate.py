"""Independent checks of the sharded plane (port of
``karpenter_tpu/sharded/validate.py``): none shares a code path with the
service's own arithmetic.

- :func:`partition_violations` — the routed partition is a disjoint
  cover: every pod on exactly one shard, signature groups never split,
  every override on a live shard and never a no-op.
- :func:`component_violations` — affinity components never split, the
  components re-derived here from raw pod labels, terms and spread
  constraints (not from the ``AffinityIndex`` the router binds through).
- :func:`state_violations` — the stacked resident state equals a fresh
  rebuild: re-partition with the current ownership map, re-encode and
  re-pack at the recorded pads, and compare the host mirror and the
  fetched device words word for word.
- :func:`rebalance_violations` — the applied decision re-derives from its
  pressure matrix through the numpy oracle, its tile rows are identical,
  and the moved groups are owned by the receiver.

Every message is the reference's, word for word: the chaos harness's
``shards-converge`` verdicts carry them.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.apis.pod import HOSTNAME_TOPOLOGY_KEY, pod_key
from karpenter_tpu_torch.sharded.router import signature_key, stable_shard


def partition_violations(service, pods) -> list[str]:
    pods = list(pods)
    out: list[str] = []
    router = service.router
    parts = router.partition(pods)
    seen: dict[str, int] = {}
    for s, part in enumerate(parts):
        for p in part:
            key = pod_key(p)
            if key in seen:
                out.append(f"pod {key} routed to shards {seen[key]} "
                           f"and {s}")
            seen[key] = s
    if len(seen) != len(pods):
        out.append(f"partition covers {len(seen)} of {len(pods)} pods")
    group_shard: dict[str, int] = {}
    for s, part in enumerate(parts):
        for p in part:
            sig = signature_key(p)
            if group_shard.setdefault(sig, s) != s:
                out.append(f"signature group {sig[:40]}... split across "
                           f"shards {group_shard[sig]} and {s}")
    for key, dst in router.overrides().items():
        if not 0 <= dst < router.num_shards:
            out.append(f"override for {key[:40]}... points at dead "
                       f"shard {dst}")
        if stable_shard(key, router.num_shards) == dst:
            out.append(f"override for {key[:40]}... is a no-op (home "
                       f"shard) — the map must stay minimal")
    return out


def component_violations(service, pods) -> list[str]:
    """Affinity components never split across shards.  The arming rules:
    a self-only zone term, an anti term matching nobody, a self hostname
    anti term, zone-scope, ScheduleAnyway and empty-selector spread
    never link groups."""
    by_sig: dict[str, object] = {}
    for p in pods:
        by_sig.setdefault(signature_key(p), p)
    keys = list(by_sig)
    if not keys:
        return []
    labels = [by_sig[k].labels_dict for k in keys]

    def matched(selector) -> list[int]:
        return [i for i, lab in enumerate(labels)
                if all(lab.get(k) == v for k, v in selector)]

    parent = list(range(len(keys)))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    linked = False
    for i, k in enumerate(keys):
        rep = by_sig[k]
        own = labels[i]
        for t in rep.affinity:
            if t.topology_key == HOSTNAME_TOPOLOGY_KEY and t.anti \
                    and all(own.get(a) == v for a, v in t.label_selector):
                continue
            others = [h for h in matched(t.label_selector) if h != i]
            for h in others:
                union(i, h)
                linked = True
        for c in rep.topology_spread:
            if c.topology_key != HOSTNAME_TOPOLOGY_KEY \
                    or c.when_unsatisfiable != "DoNotSchedule" \
                    or not c.label_selector:
                continue
            mem = matched(c.label_selector)
            for h in mem:
                union(i, h)
                if h != mem[0]:
                    union(mem[0], h)
                linked = linked or h != i
    if not linked:
        return []
    out: list[str] = []
    comp_shard: dict[int, tuple[int, str]] = {}
    router = service.router
    for i, k in enumerate(keys):
        s = router.shard_of_key(k)
        prev = comp_shard.setdefault(find(i), (s, k))
        if prev[0] != s:
            out.append(f"affinity component split: {prev[1][:40]}... on "
                       f"shard {prev[0]}, {k[:40]}... on shard {s} — "
                       f"inter-group edges are invisible to both solves")
    return out


def state_violations(service, pods, catalog) -> list[str]:
    """Word-for-word freshness of the stacked resident state against a
    rebuild (mirror and device)."""
    from karpenter_tpu_torch.sharded.encode import pack_shard_window
    from karpenter_tpu_torch.solver.encode import encode

    snap = service.snapshot_state()
    if snap is None:
        return []
    gen = (catalog.uid, catalog.generation,
           catalog.availability_generation)
    if snap["generation"] != gen:
        return [f"sharded state generation {snap['generation']} != "
                f"catalog generation {gen} (missed invalidation)"]
    G_pad, O_pad, U_pad, _N = snap["shapes"]
    parts = service.router.partition(pods)
    fresh = np.stack([pack_shard_window(encode(part, catalog), G_pad,
                                        O_pad, U_pad)
                      for part in parts])
    mirror = snap["mirror"]
    if mirror.shape != fresh.shape:
        return [f"sharded mirror shape {mirror.shape} != rebuild shape "
                f"{fresh.shape}"]
    out: list[str] = []
    for name, got in (("host mirror", mirror),
                      ("device tensors", snap["device"])):
        for s in range(fresh.shape[0]):
            diff = int(np.count_nonzero(got[s] != fresh[s]))
            if diff:
                out.append(f"shard {s} {name} diverged from a fresh "
                           f"ClusterState rebuild ({diff} words "
                           f"differ)")
    return out


def rebalance_violations(service, decision) -> list[str]:
    """Re-derive the decision from its recorded pressure matrix; check
    the tile and the applied ownership moves."""
    from karpenter_tpu_torch.sharded.kernels import rebalance_oracle

    if decision is None:
        return []
    out: list[str] = []
    donor, receiver, amount, skew = rebalance_oracle(decision.pressure)
    if (donor, receiver, amount, skew) != (decision.donor,
                                           decision.receiver,
                                           decision.amount, decision.skew):
        out.append(f"rebalance decision ({decision.donor}, "
                   f"{decision.receiver}, {decision.amount}, "
                   f"{decision.skew}) != host re-derivation "
                   f"({donor}, {receiver}, {amount}, {skew})")
    if decision.tile.size:
        rows = decision.tile[:, :4]
        if not (rows == rows[0]).all():
            out.append("rebalance decision tile differs across shards — "
                       "the collective must replicate one decision")
    for key in decision.moved_keys:
        owner = service.router.shard_of_key(key)
        if owner != decision.receiver:
            out.append(f"migrated group {key[:40]}... owned by shard "
                       f"{owner}, decision said {decision.receiver}")
    return out
