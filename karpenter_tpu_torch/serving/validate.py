"""Parity checks of the serving plane against the classic path (port of
``karpenter_tpu/serving/validate.py``).

The ring changes when a window is solved, never what is computed, so the
yardstick is the port's classic path itself:

- :func:`ring_state_violations` — the loop's device state, host mirror
  and ``RingOracle`` replay agree word for word (and, given the catalog,
  the generation is current);
- :func:`raw_parity_violations` — a ring-fed ``serve_window`` chain over
  a seeded churn stream gives the packed result of ``solve_packed_torch``
  on the freshly packed buffer, word for word, and carries the state of
  the host re-pack, every window of every seed;
- :func:`plan_parity_violations` — plans of a serving solver's
  ``serve_stream`` equal a classic solver's over the same windows.

- :func:`sharded_parity_violations` — a sharded serving loop's plans
  (deferred fetches) equal the same service class solving each window
  at once.

The checks run on any device (``device``: the card unless ``"cpu"`` is
asked for).
"""

from __future__ import annotations

import random

import numpy as np

from karpenter_tpu_torch.apis.pod import PodSpec, ResourceRequests


def _churn_stream(num_pods: int, num_types: int, windows: int, seed: int):
    """Seeded pod-churn windows + catalog: arrivals and departures per
    window, the repack loop's shape."""
    from karpenter_tpu_torch.workload import build_catalog

    catalog = build_catalog(num_types)
    rng = random.Random(f"serving-validate-{seed}")
    sizes = ((250, 512), (500, 1024), (1000, 4096), (2000, 8192))

    def mk(tag: str, i: int) -> PodSpec:
        cpu, mem = sizes[rng.randrange(len(sizes))]
        return PodSpec(f"{tag}-{i}", requests=ResourceRequests(cpu, mem, 0, 1))

    cur = [mk(f"s{seed}w0", i) for i in range(num_pods)]
    seqs = [list(cur)]
    for w in range(1, windows):
        for _ in range(rng.randrange(1, max(2, num_pods // 16))):
            cur.pop(rng.randrange(len(cur)))
        cur.extend(mk(f"s{seed}w{w}", i)
                   for i in range(rng.randrange(1, max(2, num_pods // 16))))
        seqs.append(list(cur))
    return seqs, catalog


def ring_state_violations(loop, catalog=None) -> list[str]:
    """Device state == host mirror == oracle replay, word for word."""
    snap = loop.snapshot_state()
    if snap is None:
        return []
    if catalog is not None:
        gen = (catalog.uid, catalog.generation,
               catalog.availability_generation)
        if snap["generation"] != gen:
            return [f"serving state generation {snap['generation']} != "
                    f"catalog generation {gen} (missed invalidation)"]
    mirror, device = snap["mirror"], snap["device"]
    if mirror.size != device.size:
        return [f"serving mirror size {mirror.size} != device state size "
                f"{device.size}"]
    out: list[str] = []
    diff = int(np.count_nonzero(mirror != device))
    if diff:
        out.append(f"serving host mirror diverged from device state "
                   f"({diff} words differ)")
    if snap["oracle"] is None:
        # the reference's words: the chaos harness's verdicts carry them
        out.append("serving oracle replay is cold while the ring is warm "
                   "— an admitted slot bypassed the replay")
    else:
        d = loop.oracle.diverges(device)
        if d:
            out.append(f"ring oracle replay diverged from device state "
                       f"({d} words differ after slot {snap['seq']})")
    return out


def raw_parity_violations(seeds: int = 8, num_pods: int = 48,
                          num_types: int = 6, windows: int = 4,
                          device="cuda") -> list[str]:
    """Word-level churn differential: a ring-fed ``serve_window`` chain
    against ``solve_packed_torch`` of the same freshly packed buffer —
    the result words and the carried state, every window, every seed."""
    from karpenter_tpu_torch.resident.delta import DELTA_BUCKETS, pad_delta
    from karpenter_tpu_torch.resident.kernels import new_state
    from karpenter_tpu_torch.serving.kernels import serve_window
    from karpenter_tpu_torch.serving.oracle import apply_ring_np
    from karpenter_tpu_torch.solver import TorchSolver, encode
    from karpenter_tpu_torch.solver.packed import solve_packed_torch
    from karpenter_tpu_torch.solver.torch_backend import upload

    out: list[str] = []
    solver = TorchSolver(device=device)
    dev = solver.device
    for seed in range(seeds):
        seqs, catalog = _churn_stream(num_pods, num_types, windows, seed)
        mirror = state = None
        for w, pods in enumerate(seqs):
            prep = solver._prepare(encode(pods, catalog))
            flat = prep.packed.reshape(-1)
            kw = dict(G=prep.G_pad, O=prep.O_pad, U=prep.U_pad, N=prep.N,
                      right_size=solver.options.right_size, compact=prep.K,
                      dense16=prep.dense16, coo16=prep.coo16)
            catalog_t = solver.device_offerings(catalog, prep.O_pad)
            if mirror is None or mirror.shape != flat.shape:
                mirror = flat.copy()
                state = new_state(flat, dev)
                idx = np.empty(0, dtype=np.int64)
            else:
                idx = np.nonzero(mirror != flat)[0]
                mirror[idx] = flat[idx]
            didx, dval = pad_delta(idx, flat[idx], flat.size, DELTA_BUCKETS)
            state, ring_res = serve_window(
                state, upload(didx, dev), upload(dval, dev), *catalog_t,
                **kw)
            classic = solve_packed_torch(upload(flat.copy(), dev),
                                         *catalog_t, **kw)
            ring_np = ring_res.cpu().numpy()
            classic_np = classic.cpu().numpy()
            if not np.array_equal(ring_np, classic_np):
                d = int(np.count_nonzero(ring_np != classic_np))
                out.append(f"seed {seed} window {w}: ring-fed result "
                           f"differs from classic solve_packed_torch "
                           f"({d} of {classic_np.size} words)")
            state_np = state[:-1].cpu().numpy()
            if not np.array_equal(state_np, apply_ring_np(mirror, didx,
                                                          dval)):
                d = int(np.count_nonzero(state_np != mirror))
                out.append(f"seed {seed} window {w}: carried serving state "
                           f"diverged from the host re-pack ({d} words)")
    return out


def _plan_key(plan):
    return ([(n.instance_type, n.zone, n.capacity_type,
              tuple(n.pod_names)) for n in plan.nodes],
            tuple(plan.unplaced_pods),
            round(plan.total_cost_per_hour, 9))


def plan_parity_violations(seeds: int = 8, num_pods: int = 48,
                           num_types: int = 6, windows: int = 4,
                           device="cuda") -> list[str]:
    """Decoded-plan churn differential: a serving solver's
    ``serve_stream`` against a classic solver on the same windows."""
    from karpenter_tpu_torch.solver import SolverOptions, TorchSolver, encode

    out: list[str] = []
    for seed in range(seeds):
        seqs, catalog = _churn_stream(num_pods, num_types, windows, seed)
        on = TorchSolver(SolverOptions(serving="on"), device=device)
        off = TorchSolver(SolverOptions(serving="off"), device=device)
        problems = [encode(pods, catalog) for pods in seqs]
        served = list(on.serve_stream(iter(problems), depth=2))
        for w, (plan, problem) in enumerate(zip(served, problems)):
            if _plan_key(plan) != _plan_key(off.solve_encoded(problem)):
                out.append(f"seed {seed} window {w}: serving plan differs "
                           f"from classic plan (mode history "
                           f"{on.serving.last_mode!r})")
        if on.serving.ring_windows == 0:
            out.append(f"seed {seed}: no window rode the ring: the "
                       f"differential exercised nothing")
        out.extend(ring_state_violations(on.serving, catalog))
    return out


def sharded_parity_violations(seeds: int = 4,
                              device="cuda") -> list[str]:
    """Sharded churn differential: a 2-shard ``ShardedServingLoop``'s
    deferred windows against the same service class solving
    synchronously, over 3 windows of 64 pods on 6 types per seed."""
    from karpenter_tpu_torch.serving.service import ShardedServingLoop
    from karpenter_tpu_torch.sharded.service import ShardedSolveService

    num_pods, num_types, windows, num_shards = 64, 6, 3, 2
    out: list[str] = []
    for seed in range(seeds):
        seqs, catalog = _churn_stream(num_pods, num_types, windows,
                                      1000 + seed)
        loop = ShardedServingLoop(
            ShardedSolveService(num_shards, device=device), capacity=2)
        classic_svc = ShardedSolveService(num_shards, device=device)
        handles = [loop.submit(catalog, pods=pods) for pods in seqs]
        plans = [h.result() for h in handles]
        for w, (pods, plan) in enumerate(zip(seqs, plans)):
            classic = classic_svc.solve_window(catalog, pods=pods)
            if _plan_key(plan.merged()) != _plan_key(classic.merged()):
                out.append(f"seed {seed} window {w}: {num_shards}-shard "
                           f"serving plan differs from synchronous solve")
    return out


def validate(seeds: int = 8, device="cuda") -> list[str]:
    """The three differentials."""
    out = raw_parity_violations(seeds=seeds, device=device)
    out.extend(plan_parity_violations(seeds=seeds, device=device))
    out.extend(sharded_parity_violations(seeds=max(2, seeds // 4),
                                         device=device))
    return out


__all__ = ["ring_state_violations", "raw_parity_violations",
           "plan_parity_violations", "sharded_parity_violations",
           "validate"]
