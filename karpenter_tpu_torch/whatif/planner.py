"""The K-scenario planner: one stacked solve, per-scenario outcomes
(port of ``karpenter_tpu/whatif/planner.py``).

``build_baseline`` lowers the pending window through the ordinary
``solver/encode`` path and ``resident/delta.pack_window`` (the baseline
buffer is word for word what ``TorchSolver`` would dispatch);
``WhatIfPlanner.plan`` ships K scenario deltas as one stacked pair into
``kernels.solve_scenarios`` (one stacked solve for K <= ``max_k``,
chunks above it) on the planner's device, and decodes each scenario's
packed result into a :class:`ScenarioOutcome`:

- placed / unplaced totals and the explain reason histogram (folded per
  group from the appended reason words);
- open-node count and $/h cost, with the scenario's capacity action
  applied as a sunk-cost discount (pre-provisioned nodes are paid for);
- gang park risk, the unplaced fraction of gang-group demand;
- a staleness estimate: retry windows needed to drain the unplaced
  backlog at the scenario's placement rate, in virtual seconds
  (``WHATIF_RETRY_S`` per window, a heuristic, not a measurement).

``plan_host`` is the same decode over the numpy oracle.  Each plan runs
in a ``whatif.plan`` span, as the reference's; a failed stacked solve
raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.faulttol import device_guard, device_id
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.obs.prof import get_profiler
from karpenter_tpu_torch.whatif.scenario import (
    Scenario, StackedScenarios, WhatIfBaseline, lower_scenarios,
)

# staleness-estimate cap (virtual seconds): an unplaced backlog with no
# placement progress reads as "stuck for the whole day", not infinity
_STALENESS_CAP_S = 86400.0


def build_baseline(pods, catalog, nodepool=None) -> WhatIfBaseline:
    """Encode the pending window and pack it at its bucketed pads — the
    exact production lowering (encode memo included), so scenario zero
    (no perturbations) IS the live solve problem."""
    from karpenter_tpu_torch.resident.delta import pack_window
    from karpenter_tpu_torch.solver.encode import encode

    pods = list(pods)
    problem = encode(pods, catalog, nodepool)
    packed, (G_pad, O_pad, U_pad) = pack_window(problem)
    return WhatIfBaseline(problem=problem, packed=packed, G_pad=G_pad,
                          O_pad=O_pad, U_pad=U_pad, catalog=catalog,
                          pods=len(pods))


def _estimate_nodes_for(baseline: WhatIfBaseline,
                        stacked: StackedScenarios) -> int:
    """Static node-axis size covering the LARGEST scenario: the shared
    ``estimate_nodes`` bound evaluated at the max per-group counts AND
    the min per-group caps over K (every scenario shares one N — the
    dispatch shape is static).  The cap side matters as much as the
    count side: a cap-clamping scenario (pool-shrink, quota) needs
    ceil(count/cap) nodes, far more than the baseline caps imply — an
    undersized N would exhaust the node array and report phantom
    unplaced pods."""
    from types import SimpleNamespace

    from karpenter_tpu_torch.solver.encode import estimate_nodes
    from karpenter_tpu_torch.solver.types import NODE_BUCKETS, bucket

    problem = baseline.problem
    G = problem.num_groups
    if stacked.K:
        counts = np.maximum(stacked.counts[:, :G], 0).max(axis=0)
        caps = np.maximum(stacked.caps[:, :G], 0).min(axis=0)
    else:
        counts = np.asarray(problem.group_count)
        caps = np.asarray(problem.group_cap)
    proxy = SimpleNamespace(
        group_req=problem.group_req,
        group_count=counts.astype(np.int64),
        group_cap=caps.astype(np.int64),
        catalog=baseline.catalog)
    # hard-capped at the production node-bucket ladder's top rung: a
    # garbage forecast (validator-rejected, but only AFTER the solve)
    # must not size a multi-GB node axis; absurd demand simply reads
    # as unplaced at the biggest supported shape
    n_cap = min(bucket(max(int(np.maximum(counts, 0).sum()), 1),
                       NODE_BUCKETS),
                NODE_BUCKETS[-1])
    return estimate_nodes(proxy, n_cap, NODE_BUCKETS)


@dataclass
class ScenarioOutcome:
    """One future, decoded."""

    name: str
    pods: int
    placed: int
    unplaced: int
    cost: float
    net_cost: float
    nodes_open: int
    reasons: dict[str, int]
    gang_demand: int
    gang_unplaced: int
    staleness_est_s: float
    delta_words: int
    action: dict | None = None
    action_cost_per_hour: float = 0.0
    # pods the scenario's capacity action would shield from node-boot
    # wait: pods landing on up to action.count opened nodes of the
    # pre-provisioned offering (capacity already up = no create+boot in
    # their placement latency) — the boot-exposure half of SLO risk
    action_covered_pods: int = 0
    # per-offering (opened-node count, first-8 per-node pod counts in
    # open order) — the material the service's recommendation ranking
    # derives pre-provision actions from without a second dispatch
    # (excluded from to_dict: internal, not payload)
    offering_node_pods: dict[int, tuple[int, list[int]]] = \
        field(default_factory=dict)

    @property
    def gang_park_risk(self) -> float:
        return self.gang_unplaced / max(self.gang_demand, 1)

    def to_dict(self) -> dict:
        return {
            "scenario": self.name,
            "pods": self.pods,
            "placed": self.placed,
            "unplaced": self.unplaced,
            "cost_per_hour": round(self.cost, 6),
            "net_cost_per_hour": round(self.net_cost, 6),
            "nodes_open": self.nodes_open,
            "reasons": dict(self.reasons),
            "gang_demand": self.gang_demand,
            "gang_unplaced": self.gang_unplaced,
            "gang_park_risk": round(self.gang_park_risk, 4),
            "p99_staleness_est_s": round(self.staleness_est_s, 3),
            "delta_words": self.delta_words,
            "action": self.action,
            "action_cost_per_hour": round(self.action_cost_per_hour, 6),
            "action_covered_pods": self.action_covered_pods,
        }


@dataclass
class WhatIfPlan:
    """One planning pass: K outcomes + the raw material the validator
    replays (stacked deltas, result words, dispatch shapes)."""

    baseline: WhatIfBaseline
    stacked: StackedScenarios
    outcomes: list[ScenarioOutcome]
    raw: np.ndarray                 # int32 [K, Lo]
    N: int
    K_coo: int
    coo16: bool
    backend: str
    dispatches: int
    plan_seconds: float = 0.0
    right_size: bool = True
    device: torch.device | None = None    # the planner's device


class WhatIfPlanner:
    """Stacked scenario solves against a transient baseline on
    ``device`` (``"cuda"`` by default, which raises without a card;
    ``"cpu"`` runs the kernels' plain versions).  Nothing stays on the
    device between plans but the catalog tensors: the baseline
    re-derives from the pending window every tick."""

    MAX_DEVICE_CATALOGS = 4

    def __init__(self, max_k: int | None = None, right_size: bool = True,
                 device="cuda"):
        from karpenter_tpu_torch.whatif import WHATIF_MAX_K

        self.max_k = max_k if max_k is not None else WHATIF_MAX_K
        self.right_size = right_size
        self.device = resolve_device(device)
        self._device_catalog: dict[tuple, tuple] = {}
        self.plans = 0
        self.chunked_plans = 0

    # -- catalog tensors (device-resident, generation-keyed) ---------------

    def _catalog_tensors(self, catalog, O_pad: int):
        """(off_alloc int32 [O, 4], off_price, off_rank float32 [O]) on
        the planner's device, cached by catalog generation."""
        from karpenter_tpu_torch.solver.torch_backend import _pad1, _pad2

        key = (catalog.uid, catalog.generation,
               catalog.availability_generation, O_pad,
               getattr(catalog, "risk_generation", 0))
        cached = self._device_catalog.get(key)
        if cached is None:
            for k in [k for k in self._device_catalog
                      if k[0] == catalog.uid and k != key]:
                self._device_catalog.pop(k)
            while len(self._device_catalog) >= self.MAX_DEVICE_CATALOGS:
                self._device_catalog.pop(next(iter(self._device_catalog)))
            arrays = (_pad2(catalog.offering_alloc().astype(np.int32),
                            O_pad),
                      _pad1(catalog.off_price.astype(np.float32), O_pad),
                      _pad1(catalog.offering_rank_price(), O_pad))
            cached = tuple(torch.from_numpy(np.ascontiguousarray(a))
                           .to(self.device) for a in arrays)
            self._device_catalog[key] = cached
            get_devtel().note_catalog_upload(
                int(sum(a.nbytes for a in arrays)))
        return cached

    # -- output shape ------------------------------------------------------

    @staticmethod
    def _output_opts(baseline: WhatIfBaseline, stacked: StackedScenarios,
                     N: int) -> tuple[int, bool, bool]:
        """(K_coo, dense16, coo16) for the solve: the COO tail is sized
        from the LARGEST scenario's pod total (nnz <= placed pods <= that
        total, so the compacted fetch never drops entries)."""
        from karpenter_tpu_torch.solver.torch_backend import (
            clamp_output_opts,
        )
        from karpenter_tpu_torch.solver.types import COO_BUCKETS, bucket

        max_pods = int(np.maximum(stacked.counts, 0).sum(axis=1).max()) \
            if stacked.K else 1
        K0 = bucket(max(max_pods, 1), COO_BUCKETS)
        return clamp_output_opts(K0, False, baseline.G_pad, N)

    # -- the stacked solve -------------------------------------------------

    def plan(self, baseline: WhatIfBaseline,
             scenarios: list[Scenario]) -> WhatIfPlan:
        """Lower -> one stacked solve per ``max_k`` scenarios -> decode."""
        from karpenter_tpu_torch.whatif.kernels import solve_scenarios

        t0 = time.perf_counter()
        with obs.span("whatif.plan", backend="device",
                      scenarios=len(scenarios)) as sp:
            stacked = lower_scenarios(baseline, scenarios)
            N = _estimate_nodes_for(baseline, stacked)
            K_coo, dense16, coo16 = self._output_opts(baseline, stacked, N)
            ct = self._catalog_tensors(baseline.catalog, baseline.O_pad)
            base = torch.from_numpy(baseline.packed).to(self.device)
            K = stacked.K
            outs: list[np.ndarray] = []
            dispatches = 0
            ids = [device_id(self.device)]
            for lo in range(0, K, self.max_k):
                hi = min(lo + self.max_k, K)
                get_devtel().note_dispatch(
                    "whatif",
                    (hi - lo, stacked.D, baseline.G_pad, baseline.O_pad,
                     baseline.U_pad, N, K_coo, coo16, self.right_size),
                    h2d_bytes=int(baseline.packed.nbytes
                                  + stacked.didx[lo:hi].nbytes
                                  + stacked.dval[lo:hi].nbytes),
                    donated=True)
                with device_guard("whatif", devices=ids) as guard:
                    with get_profiler().sampled("whatif") as probe:
                        didx = torch.from_numpy(stacked.didx[lo:hi]).to(
                            self.device)
                        dval = torch.from_numpy(stacked.dval[lo:hi]).to(
                            self.device)
                        out = solve_scenarios(
                            base, didx, dval, *ct, G=baseline.G_pad,
                            O=baseline.O_pad, U=baseline.U_pad, N=N,
                            right_size=self.right_size, compact=K_coo,
                            dense16=dense16, coo16=coo16)
                        probe.dispatched(out)
                    out_np = guard.fetch(out)
                get_devtel().note_d2h(int(out_np.nbytes))
                outs.append(out_np)
                dispatches += 1
            raw = np.concatenate(outs) if len(outs) > 1 else outs[0]
            plan = self._decode(baseline, stacked, raw, N, K_coo, coo16,
                                backend="device", dispatches=dispatches)
            sp.set("dispatches", dispatches)
            sp.set("delta_rung", stacked.D)
        plan.plan_seconds = time.perf_counter() - t0
        self.plans += 1
        if dispatches > 1:
            self.chunked_plans += 1
        return plan

    def plan_host(self, baseline: WhatIfBaseline,
                  scenarios: list[Scenario]) -> WhatIfPlan:
        """The same plan from the numpy oracle, scenario at a time (equal
        to the device path on every word but the float cost word)."""
        from karpenter_tpu_torch.whatif.oracle import solve_scenarios_np

        t0 = time.perf_counter()
        with obs.span("whatif.plan", backend="host",
                      scenarios=len(scenarios)):
            stacked = lower_scenarios(baseline, scenarios)
            N = _estimate_nodes_for(baseline, stacked)
            K_coo, dense16, coo16 = self._output_opts(baseline, stacked, N)
            raw = solve_scenarios_np(baseline, stacked, N=N,
                                     right_size=self.right_size,
                                     compact=K_coo, dense16=dense16,
                                     coo16=coo16)
            plan = self._decode(baseline, stacked, raw, N, K_coo, coo16,
                                backend="host", dispatches=0)
        plan.plan_seconds = time.perf_counter() - t0
        self.plans += 1
        return plan

    # -- decode ------------------------------------------------------------

    def _decode(self, baseline: WhatIfBaseline, stacked: StackedScenarios,
                raw: np.ndarray, N: int, K_coo: int, coo16: bool,
                backend: str, dispatches: int) -> WhatIfPlan:
        from karpenter_tpu_torch.explain import fold_reason
        from karpenter_tpu_torch.obs.telemetry_words import decode_and_record
        from karpenter_tpu_torch.solver.result_layout import (
            TELEMETRY_LEN, unpack_reason_words,
        )
        from karpenter_tpu_torch.solver.torch_backend import unpack_result
        from karpenter_tpu_torch.whatif import WHATIF_RETRY_S

        G = baseline.G_pad
        G_real = baseline.problem.num_groups
        gang_mask = np.asarray(baseline.problem.group_gang) >= 0
        price = np.asarray(baseline.catalog.off_price, dtype=np.float64)
        outcomes: list[ScenarioOutcome] = []
        if backend == "device":
            get_devtel().note_telemetry_d2h(
                len(stacked.scenarios) * TELEMETRY_LEN * 4)
        for k, scenario in enumerate(stacked.scenarios):
            node_off, assign, unp, cost = unpack_result(
                raw[k], G, N, K_coo, coo16=coo16)
            words = unpack_reason_words(raw[k], G, N, K_coo, coo16=coo16)
            if backend == "device":
                decode_and_record(
                    raw[k], G, N, K_coo, coo16=coo16, plane="whatif",
                    delta_words=int(stacked.delta_words[k]))
            counts = stacked.counts[k][:G_real]
            unp_r = unp[:G_real].astype(np.int64)
            pods = int(counts.sum())
            unplaced = int(unp_r.sum())
            placed = int((counts - unp_r).sum())
            reasons: dict[str, int] = {}
            if words is not None:
                for gi in np.nonzero(unp_r > 0)[0]:
                    name = fold_reason(int(words[gi])) or "unknown"
                    reasons[name] = reasons.get(name, 0) \
                        + int(unp_r[gi])
            open_off = node_off[node_off >= 0]
            nodes_open = int(open_off.size)
            # per-offering (opened-node count, first-8 per-node pod
            # counts in open order) — vectorized: the stable sort keeps
            # open order within each offering
            offering_node_pods: dict[int, tuple[int, list[int]]] = {}
            if nodes_open:
                open_idx = np.nonzero(node_off >= 0)[0]
                pods_n = assign[:, open_idx].sum(axis=0)
                order = np.argsort(open_off, kind="stable")
                uoff, starts = np.unique(open_off[order],
                                         return_index=True)
                for i, off in enumerate(uoff):
                    hi = starts[i + 1] if i + 1 < len(uoff) else None
                    seg = pods_n[order[starts[i]:hi]]
                    offering_node_pods[int(off)] = \
                        (int(seg.size), [int(x) for x in seg[:8]])
            cost = float(cost)
            net_cost = cost
            action_dict = None
            action_cost = 0.0
            action_covered = 0
            if scenario.action is not None:
                a = scenario.action
                opened = int((open_off == a.offering).sum())
                if 0 <= a.offering < price.shape[0]:
                    unit = float(price[a.offering])
                    net_cost = cost - min(opened, int(a.count)) * unit
                    action_cost = unit * int(a.count)
                # pods shielded from boot wait: those landing on the
                # first count opened nodes of the action's offering
                # (node order is the solve's deterministic open order)
                _n, pods_list = offering_node_pods.get(
                    int(a.offering), (0, []))
                action_covered = sum(pods_list[:int(a.count)])
                action_dict = a.describe(baseline.catalog)
            gang_demand = int(counts[gang_mask].sum()) \
                if gang_mask.any() else 0
            gang_unplaced = int(unp_r[gang_mask].sum()) \
                if gang_mask.any() else 0
            if unplaced <= 0:
                staleness = 0.0
            elif placed <= 0:
                staleness = _STALENESS_CAP_S
            else:
                staleness = min(
                    WHATIF_RETRY_S * (1.0 + unplaced / placed),
                    _STALENESS_CAP_S)
            outcomes.append(ScenarioOutcome(
                name=scenario.name, pods=pods, placed=placed,
                unplaced=unplaced, cost=cost, net_cost=net_cost,
                nodes_open=nodes_open, reasons=reasons,
                gang_demand=gang_demand, gang_unplaced=gang_unplaced,
                staleness_est_s=staleness,
                delta_words=stacked.delta_words[k],
                action=action_dict, action_cost_per_hour=action_cost,
                action_covered_pods=action_covered,
                offering_node_pods=offering_node_pods))
        return WhatIfPlan(baseline=baseline, stacked=stacked,
                          outcomes=outcomes, raw=raw, N=N, K_coo=K_coo,
                          coo16=coo16, backend=backend,
                          dispatches=dispatches,
                          right_size=self.right_size, device=self.device)
