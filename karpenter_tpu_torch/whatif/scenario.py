"""Scenario algebra: composable perturbations of the packed baseline
(port of ``karpenter_tpu/whatif/scenario.py``).

A scenario is the baseline window plus a composition of perturbations
(arrival waves, disruptions taken from chaos-profile knobs, candidate
capacity actions), and its only lowered form is a word delta against
the packed baseline buffer (``resident/delta.diff_words`` +
``pad_delta``).  K scenarios ship to the device as one stacked
``[K, D]`` (indices, values) pair on top of one baseline buffer, never
K full encodes.  Every solve-visible perturbation is a handful of word
edits:

- **arrival wave** -> the group's meta count word (``g*8 + 4``);
- **spot storm / zone blackout / capacity quota** -> label-row bit words
  (the offerings masked out of every row; the unpack re-ANDs the fit on
  the device, so a cleared bit removes the offering as a blackout
  would);
- **pool shrink / quota clamp** -> the group's meta cap word
  (``g*8 + 5``).

Actions that add capacity (:class:`PreProvision`) leave the solve
problem alone: pre-provisioned nodes are sunk cost, a decode-side
discount in the planner, so a scenario's solve words do not depend on
its action (which the validator's fresh-solve check needs).

Perturbations are not sanitized here: garbage counts reach the scenario
buffer, where ``validate_whatif`` rejects them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from karpenter_tpu_torch.resident.delta import (
    DELTA_BUCKETS, diff_words, pad_delta,
)

_I32_MIN = -(2 ** 31)
_I32_MAX = 2 ** 31 - 1

# meta-row columns (pack_input layout; docs/design/packed-io.md)
_COL_COUNT = 4
_COL_CAP = 5


@dataclass(frozen=True)
class WhatIfBaseline:
    """The packed baseline every scenario perturbs: one encoded pending
    window at its bucketed pads (``resident/delta.pack_window``'s exact
    lowering, so the buffer is word-identical to what the production
    solver would dispatch)."""

    problem: object                 # EncodedProblem
    packed: np.ndarray              # int32 [L]
    G_pad: int
    O_pad: int
    U_pad: int
    catalog: object
    pods: int = 0

    @property
    def L(self) -> int:
        return int(self.packed.size)

    def base_counts(self) -> np.ndarray:
        return self.packed[:self.G_pad * 8].reshape(
            self.G_pad, 8)[:, _COL_COUNT].copy()

    def group_signature(self, gi: int) -> str:
        """The encoder group's constraint-signature key, the arrival
        table's grouping key, so a forecasted wave lands on the solve
        group its history came from."""
        return self.problem.groups[gi].representative.signature_key()


# ---------------------------------------------------------------------------
# Perturbations (solve-visible: lowered to word edits)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArrivalWave:
    """Extra pending pods per baseline group: ``waves`` is a tuple of
    (group_index, extra_pods).  The forecast's lowered form."""

    waves: tuple[tuple[int, int], ...]

    def apply(self, buf: np.ndarray, baseline: WhatIfBaseline) -> None:
        for gi, extra in self.waves:
            if not 0 <= gi < baseline.G_pad:
                continue
            w = gi * 8 + _COL_COUNT
            buf[w] = np.int32(np.clip(int(buf[w]) + int(extra),
                                      _I32_MIN, _I32_MAX))


@dataclass(frozen=True)
class OfferingMask:
    """Remove a set of offerings from every label row — the lowered form
    of a chaos disruption (spot storm, zone blackout, (type, zone)
    capacity quota)."""

    label: str
    offerings: tuple[int, ...]

    def apply(self, buf: np.ndarray, baseline: WhatIfBaseline) -> None:
        O_pad, U_pad, G_pad = baseline.O_pad, baseline.U_pad, baseline.G_pad
        if not self.offerings:
            return
        bits = np.zeros(O_pad, dtype=np.uint8)
        offs = [o for o in self.offerings if 0 <= o < O_pad]
        bits[offs] = 1
        # the exact packbits transform pack_input applies per label row
        mask = np.packbits(bits.reshape(O_pad // 32, 32), axis=-1,
                           bitorder="little").reshape(-1).view(np.int32)
        rows = buf[G_pad * 8:].reshape(U_pad, O_pad // 32)
        rows &= ~mask[None, :]


@dataclass(frozen=True)
class CapClamp:
    """Clamp per-group pod caps — the lowered form of a pool shrink or
    an instance-quota perturbation: ``caps`` is (group_index, new_cap)."""

    caps: tuple[tuple[int, int], ...]

    def apply(self, buf: np.ndarray, baseline: WhatIfBaseline) -> None:
        for gi, cap in self.caps:
            if not 0 <= gi < baseline.G_pad:
                continue
            w = gi * 8 + _COL_CAP
            buf[w] = np.int32(np.clip(int(cap), _I32_MIN, _I32_MAX))


# ---------------------------------------------------------------------------
# Capacity actions (decode-side: sunk-cost discount, never a word edit)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PreProvision:
    """Pre-provision ``count`` nodes of ``offering`` ahead of the
    horizon.  Solve-invisible by design (the solver already opens the
    nodes the demand needs); the planner discounts up to ``count``
    opened nodes of this offering as already-paid capacity and prices
    the action at ``count * off_price[offering]`` per hour."""

    offering: int
    count: int

    def describe(self, catalog) -> dict:
        itype, zone, cap = catalog.describe_offering(self.offering)
        return {"kind": "pre_provision", "offering": int(self.offering),
                "instance_type": itype, "zone": zone, "capacity_type": cap,
                "count": int(self.count),
                "cost_per_hour": round(
                    float(catalog.off_price[self.offering])
                    * int(self.count), 6)}


@dataclass(frozen=True)
class Scenario:
    """One named future: a perturbation composition + optional capacity
    action.  ``key()`` is the canonical form the determinism digest and
    the audit registry use."""

    name: str
    perturbations: tuple = ()
    action: PreProvision | None = None

    def key(self) -> str:
        return repr((self.name, self.perturbations, self.action))


# ---------------------------------------------------------------------------
# Declarative perturbation builders
# ---------------------------------------------------------------------------

def spot_storm_mask(catalog, frac: float = 1.0, rng=None) -> OfferingMask:
    """Every spot offering interrupted (the chaos spot-storm knob,
    ``preempt_storm_frac`` < 1 thins the set through the seeded rng)."""
    from karpenter_tpu_torch.catalog.arrays import CAPACITY_TYPES

    spot_idx = CAPACITY_TYPES.index("spot")
    offs = [int(o) for o in np.nonzero(
        np.asarray(catalog.off_cap) == spot_idx)[0]]
    if frac < 1.0 and rng is not None:
        offs = [o for o in offs if rng.random() < frac]
    return OfferingMask(label="spot-storm", offerings=tuple(offs))


def zone_blackout_mask(catalog, zone: str) -> OfferingMask:
    """Every offering in ``zone`` gone (the chaos capacity-blackout
    knob, widened to the whole zone)."""
    try:
        zi = catalog.zones.index(zone)
    except ValueError:
        return OfferingMask(label=f"zone-blackout:{zone}", offerings=())
    offs = [int(o) for o in np.nonzero(
        np.asarray(catalog.off_zone) == zi)[0]]
    return OfferingMask(label=f"zone-blackout:{zone}", offerings=tuple(offs))


def quota_clamp(baseline: WhatIfBaseline, quota: int) -> CapClamp:
    """Clamp every live group's per-node pod cap to ``quota`` — the
    declarative form of the chaos ``instance_quota`` knob at the
    solve-problem level."""
    meta = baseline.packed[:baseline.G_pad * 8].reshape(baseline.G_pad, 8)
    caps = tuple((int(g), int(min(int(meta[g, _COL_CAP]), int(quota))))
                 for g in range(baseline.problem.num_groups))
    return CapClamp(caps=caps)


def perturbations_from_profile(profile, catalog,
                               baseline: WhatIfBaseline, rng) -> tuple:
    """A :class:`ChaosProfile`'s storm, blackout and quota knobs as
    scenario perturbations.  ``rng`` is the scenario seed's stream: a
    profile and a seed determine the perturbation set."""
    out: list = []
    if profile.preempt_storm_rate > 0.0:
        out.append(spot_storm_mask(catalog, profile.preempt_storm_frac,
                                   rng))
    if profile.capacity_blackout_rate > 0.0 and catalog.zones:
        zone = catalog.zones[rng.randrange(len(catalog.zones))]
        out.append(zone_blackout_mask(catalog, zone))
    if profile.instance_quota:
        out.append(quota_clamp(baseline, profile.instance_quota))
    return tuple(out)


def wave_from_forecast(baseline: WhatIfBaseline,
                       expected: dict[str, int],
                       scale: float = 1.0) -> ArrivalWave:
    """Forecasted arrivals per signature onto the baseline's groups (the
    first group of each signature).  Signatures the baseline lacks are
    dropped; counts pass unsanitized, so garbage rates reach
    ``validate_whatif``."""
    by_sig: dict[str, int] = {}
    for gi in range(baseline.problem.num_groups):
        sig = baseline.group_signature(gi)
        if sig not in by_sig:
            by_sig[sig] = gi
    waves = []
    for sig, n in sorted(expected.items()):
        gi = by_sig.get(sig)
        if gi is not None:
            waves.append((gi, int(round(n * scale))))
    return ArrivalWave(waves=tuple(waves))


# ---------------------------------------------------------------------------
# Lowering: scenarios -> one stacked delta pair
# ---------------------------------------------------------------------------

@dataclass
class StackedScenarios:
    """K scenarios lowered against one baseline: the stacked ``[K, D]``
    delta pair the kernel consumes, plus the host-derived per-scenario
    meta the decoder needs (counts, caps, totals)."""

    scenarios: list[Scenario]
    didx: np.ndarray                # int32 [K, D]
    dval: np.ndarray                # int32 [K, D]
    counts: np.ndarray              # int32/int64 [K, G_pad]
    caps: np.ndarray                # [K, G_pad]
    delta_words: list[int]
    D: int

    @property
    def K(self) -> int:
        return len(self.scenarios)


def perturbed_buffer(baseline: WhatIfBaseline,
                     scenario: Scenario) -> np.ndarray:
    """The scenario's full perturbed buffer (host scratch): baseline
    copy + perturbations applied in composition order.  The lowering,
    the oracle, and the validator all derive the scenario state through
    this one function, so 'the perturbed state' cannot fork."""
    buf = baseline.packed.copy()
    for p in scenario.perturbations:
        p.apply(buf, baseline)
    return buf


def lower_scenarios(baseline: WhatIfBaseline,
                    scenarios: list[Scenario]) -> StackedScenarios:
    """Lower K scenarios to ONE stacked delta pair at a shared bucket
    rung (the dispatch shape must be rectangular, like the sharded
    plane's stacked deltas).  Padding rows carry the drop index (L, one
    past the buffer), which the device scatter writes into a spare word
    that the solve never reads (``kernels.apply_deltas``)."""
    L = baseline.L
    G_pad = baseline.G_pad
    idxs: list[np.ndarray] = []
    vals: list[np.ndarray] = []
    counts = np.zeros((len(scenarios), G_pad), dtype=np.int64)
    caps = np.zeros((len(scenarios), G_pad), dtype=np.int64)
    for k, s in enumerate(scenarios):
        buf = perturbed_buffer(baseline, s)
        idx = diff_words(baseline.packed, buf)
        idxs.append(idx)
        vals.append(buf[idx])
        meta = buf[:G_pad * 8].reshape(G_pad, 8)
        counts[k] = meta[:, _COL_COUNT]
        caps[k] = meta[:, _COL_CAP]
    from karpenter_tpu_torch.solver.types import bucket

    d_max = max([int(i.size) for i in idxs] or [1])
    rung = (bucket(max(d_max, 1), DELTA_BUCKETS),)
    pairs = [pad_delta(i, v, L, rung) for i, v in zip(idxs, vals)]
    return StackedScenarios(
        scenarios=list(scenarios),
        didx=np.stack([p[0] for p in pairs]),
        dval=np.stack([p[1] for p in pairs]),
        counts=counts, caps=caps,
        delta_words=[int(i.size) for i in idxs],
        D=int(rung[0]))
