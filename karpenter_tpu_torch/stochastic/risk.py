"""Spot-interruption risk model: per-(type, zone) rates from the ledger.

The placement ledger keeps LABELED lifecycle history for spot
capacity (obs/ledger.py ``node_seen`` / ``interruption``): every spot
scan round counts one exposure per live spot instance, every observed
spot preemption counts one interruption — both stamped by the
production ``SpotPreemptionController`` from ground-truth cloud state,
so chaos spot-storm / overload / oversubscribe runs generate exactly
the histories production would.

The model is deliberately a COUNT-REPRODUCING estimator, not a fitted
curve: ``rate = interruptions / max(exposures, 1)``, clamped to [0, 1].
That is what makes the chaos ``risk-model-consistent`` invariant sharp
— the priced rates must equal the ledger's observed counts EXACTLY, so
any drift between what the solver prices and what the fleet actually
experienced is a violation, not a tolerance.  An empty ledger degrades
to the zero-risk prior: every rate is exactly 0.0, no NaN z-scores, no
division by zero (tests/test_stochastic.py pins both).

Pricing: expected eviction cost enters offering RANKING (the choice
tensor), never real cost accounting — a spot offering with observed
interruption rate r ranks as ``rank * (1 + RISK_LAMBDA * r)``, so
cost-comparable placements prefer capacity that historically survives.
The model persists across restarts through the recovery journal's
keyed state records (``spot_risk/<type>/<zone>``), the same channel
nominations and gang admissions ride.

(Copy of ``karpenter_tpu/stochastic/risk.py``.)
"""

from __future__ import annotations

import threading

from karpenter_tpu_torch.utils import metrics

# ranking penalty weight: a spot offering observed interrupted on every
# exposure ranks as (1 + RISK_LAMBDA)x its price — strong enough to
# lose ties against clean zones, never a hard mask (availability
# blackouts own the hard path)
RISK_LAMBDA = 1.0

STATE_PREFIX = "spot_risk/"


class SpotRiskModel:
    """Per-(instance type, zone) spot-interruption rates (see module
    docstring).  Thread-safe; counts are plain integers so snapshots
    and the consistency invariant compare exactly."""

    def __init__(self):
        self._lock = threading.Lock()
        self._interrupted: dict[tuple[str, str], int] = {}
        self._exposure: dict[tuple[str, str], int] = {}
        self.generation = 0

    # -- learning ----------------------------------------------------------

    @classmethod
    def from_ledger(cls, ledger) -> "SpotRiskModel":
        """Rebuild from the ledger's labeled lifecycle history — the
        canonical constructor (chaos re-derives through this same path
        for the consistency invariant)."""
        model = cls()
        hist = ledger.interruption_history()
        with model._lock:
            model._interrupted = dict(hist.get("interrupted", {}))
            model._exposure = dict(hist.get("exposure", {}))
            model.generation += 1
        return model

    def observe(self, itype: str, zone: str, *, interrupted: int = 0,
                exposure: int = 0) -> None:
        with self._lock:
            key = (itype, zone)
            if interrupted:
                self._interrupted[key] = \
                    self._interrupted.get(key, 0) + interrupted
            if exposure:
                self._exposure[key] = \
                    self._exposure.get(key, 0) + exposure
            self.generation += 1

    # -- readout -----------------------------------------------------------

    def rate(self, itype: str, zone: str) -> float:
        """Observed interruption rate in [0, 1]; 0.0 (zero-risk prior)
        when the pair was never exposed — never NaN, never a division
        by zero."""
        with self._lock:
            key = (itype, zone)
            n = self._interrupted.get(key, 0)
            d = self._exposure.get(key, 0)
        if d <= 0:
            # interruptions with no recorded exposure (history trimmed,
            # partial journal) still price as fully risky, not as safe
            return 1.0 if n > 0 else 0.0
        return min(1.0, n / d)

    def counts(self) -> dict[tuple[str, str], tuple[int, int]]:
        """(interrupted, exposure) per pair — the invariant's exact
        comparison surface."""
        with self._lock:
            keys = set(self._interrupted) | set(self._exposure)
            return {k: (self._interrupted.get(k, 0),
                        self._exposure.get(k, 0)) for k in sorted(keys)}

    def snapshot(self) -> dict:
        """The /debug/risk payload."""
        rows = []
        for (itype, zone), (n, d) in self.counts().items():
            rows.append({"instance_type": itype, "zone": zone,
                         "interrupted": n, "exposure": d,
                         "rate": round(self.rate(itype, zone), 6)})
        return {"risk_lambda": RISK_LAMBDA, "generation": self.generation,
                "pairs": rows}

    def update_metrics(self) -> None:
        """Refresh ``karpenter_tpu_spot_risk_rate{instance_type, zone}``
        for every observed pair (cardinality bounded by the catalog:
        types x zones)."""
        for (itype, zone), _ in self.counts().items():
            metrics.SPOT_RISK_RATE.labels(itype, zone).set(
                self.rate(itype, zone))

    # -- pricing -----------------------------------------------------------

    def risk_column(self, catalog, lam: float = RISK_LAMBDA):
        """Pure form of the pricing: the float32 [O] expected-eviction
        column this model implies for ``catalog`` — spot offerings get
        ``lam * rate``, on-demand stays 0.  The chaos consistency
        invariant re-derives this column independently and compares it
        to what the catalog actually carries."""
        import numpy as np

        from karpenter_tpu_torch.catalog.arrays import CAPACITY_TYPES

        spot_idx = CAPACITY_TYPES.index("spot")
        risk = np.zeros(catalog.num_offerings, dtype=np.float32)
        for o in range(catalog.num_offerings):
            if int(catalog.off_cap[o]) != spot_idx:
                continue
            itype, zone, _cap = catalog.describe_offering(o)
            r = self.rate(itype, zone)
            if r > 0.0:
                risk[o] = np.float32(lam * r)
        return risk

    def price_catalog(self, catalog, lam: float = RISK_LAMBDA) -> None:
        """Attach expected-eviction-cost ranking to a catalog: spot
        offerings gain ``off_risk = lam * rate`` (on-demand stays 0),
        and the catalog's risk generation bumps so device-resident rank
        tensors re-upload (solver keys on it).  Idempotent for an
        unchanged model: the generation bumps only when the column
        actually changed."""
        import numpy as np

        risk = self.risk_column(catalog, lam)
        prev = getattr(catalog, "off_risk", None)
        if prev is not None and np.array_equal(prev, risk):
            return
        catalog.off_risk = risk
        catalog.risk_generation = getattr(catalog, "risk_generation", 0) + 1

    # -- persistence (recovery journal state records) ----------------------

    def save(self, journal) -> None:
        """One keyed state record per observed pair — newest-wins, so a
        restart rebuilds the exact counts (recovery/journal.py)."""
        for (itype, zone), (n, d) in self.counts().items():
            journal.state(f"{STATE_PREFIX}{itype}/{zone}",
                          {"interrupted": n, "exposure": d})

    @classmethod
    def load(cls, journal) -> "SpotRiskModel":
        model = cls()
        for key, value in journal.state_map().items():
            if not key.startswith(STATE_PREFIX) or not isinstance(value,
                                                                  dict):
                continue
            rest = key[len(STATE_PREFIX):]
            parts = rest.rsplit("/", 1)
            if len(parts) != 2:
                continue
            itype, zone = parts
            model.observe(itype, zone,
                          interrupted=int(value.get("interrupted", 0)),
                          exposure=int(value.get("exposure", 0)))
        return model


_MODEL = SpotRiskModel()


def get_risk_model() -> SpotRiskModel:
    return _MODEL


def refresh_from_ledger(ledger) -> SpotRiskModel:
    """Rebuild the process model from the ledger history and refresh
    its metric family — the /debug/risk and chaos pump entry point."""
    global _MODEL
    _MODEL = SpotRiskModel.from_ledger(ledger)
    _MODEL.update_metrics()
    return _MODEL
