"""Deterministic arrival forecasting from the ledger's arrival table
(port of ``karpenter_tpu/whatif/forecast.py``).

The placement ledger keeps a bounded per-(signature group, virtual hour)
arrival count table (``obs/ledger.py`` ``arrival`` / ``arrival_history``),
stamped at the intake every pod shares.  The forecaster turns it into
expected arrivals per signature group over a planning horizon:

- **base rate**: a recency EWMA over the group's counts per absolute
  virtual hour, in chronological order (an hour-of-day EWMA would weight
  a group by which clock hours its demand lands in).  A journal-loaded
  table has no series and falls back to the mean hourly rate (total /
  24);
- **diurnal profile**: the global per-hour multiplier, blended with a
  prior from the soak load model (``chaos/soak.PRODUCTION_DAY``'s
  segment loads stretched over 24 hours); a cold ledger gives the prior
  alone, never NaN.

Both are pure functions of the ledger: no clocks, no randomness, so the
what-if determinism check (same ledger + seed => the same
recommendation digest) is sharp.  The table persists across restarts in
the recovery journal's keyed state records (``whatif_forecast/<digest>``),
as the spot-risk model does.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np

from karpenter_tpu_torch.obs.trace import now

HOURS = 24

# EWMA recency weight over the CHRONOLOGICAL per-absolute-hour counts
# (alpha toward the most recent observed hour)
EWMA_ALPHA = 0.35

STATE_PREFIX = "whatif_forecast/"


def _table_fingerprint(counts: dict[str, list[int]]) -> int:
    """Content fingerprint of an arrival table (stable 31-bit int).
    Used as the rebuilt forecaster's ``generation``: the service builds
    a FRESH forecaster every pass, so a per-instance counter would read
    the same number forever, and a total-count generation saturates at
    the ring capacity while the ring keeps rotating — the audit fields
    and the journal-save gate need a number that changes exactly when
    the table content does, and reproduces for the determinism digest."""
    h = hashlib.blake2b(digest_size=4)
    for sig in sorted(counts):
        h.update(sig.encode())
        h.update(bytes(str(counts[sig]), "utf-8"))
    return int.from_bytes(h.digest(), "big") & 0x7FFFFFFF


def soak_diurnal_prior() -> np.ndarray:
    """float64 [24] multipliers (mean 1.0) derived from the soak load
    model: chaos/soak.PRODUCTION_DAY's segments, each stretched over its
    proportional share of the 24-hour day, carrying its load factor —
    the same diurnal shape `make soak` replays.  The cold-ledger prior:
    with no observed arrivals the forecaster still knows mornings ramp
    and midday peaks."""
    from karpenter_tpu_torch.chaos.soak import PRODUCTION_DAY

    total_rounds = sum(seg.rounds for seg in PRODUCTION_DAY)
    prof = np.ones(HOURS, dtype=np.float64)
    hour = 0.0
    for seg in PRODUCTION_DAY:
        span = HOURS * seg.rounds / max(total_rounds, 1)
        lo, hi = int(hour), int(min(hour + span, HOURS))
        prof[lo:max(hi, lo + 1)] = seg.load
        hour += span
    mean = float(prof.mean())
    return prof / max(mean, 1e-9)


class ArrivalForecaster:
    """Per-signature-group arrival rates + diurnal profile (see module
    docstring).  Thread-safe; counts are plain integers so rebuilds and
    the determinism digest compare exactly."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, list[int]] = {}   # sig -> [24] counts
        # chronological (signature, absolute-hour) events when built
        # from a live ledger; None for journal-loaded/merged tables
        # (whose rates fall back to the mean hourly rate)
        self._series: list[tuple[str, int]] | None = None
        self.generation = 0
        self.built_at = 0.0

    # -- learning ----------------------------------------------------------

    @classmethod
    def from_ledger(cls, ledger) -> "ArrivalForecaster":
        """Rebuild from the ledger's arrival table — the canonical
        constructor (the determinism check re-derives through this same
        path).  The generation is the table's content fingerprint (see
        :func:`_table_fingerprint`)."""
        model = cls()
        table = ledger.arrival_history()
        series = ledger.arrival_series()
        with model._lock:
            model._counts = {sig: list(row) for sig, row in
                             sorted(table.items())}
            model._series = series
            model.generation = _table_fingerprint(model._counts)
            model.built_at = now()
        return model

    def merged_with(self, other: "ArrivalForecaster"
                    ) -> "ArrivalForecaster":
        """Elementwise-max merge — the restart warm-start: the journal
        snapshot is an earlier state of the SAME bounded ring, so max
        per (signature, hour) restores history the fresh ring hasn't
        re-observed yet without ever double-counting, and is idempotent
        (merging the snapshot twice changes nothing)."""
        with other._lock:
            theirs = {sig: list(row) for sig, row in other._counts.items()}
        out = ArrivalForecaster()
        with self._lock:
            mine = {sig: list(row) for sig, row in self._counts.items()}
        for sig in sorted(set(mine) | set(theirs)):
            a = mine.get(sig, [0] * HOURS)
            b = theirs.get(sig, [0] * HOURS)
            out._counts[sig] = [max(x, y) for x, y in zip(a, b)]
        out.generation = _table_fingerprint(out._counts)
        out.built_at = self.built_at
        return out

    # -- readout -----------------------------------------------------------

    def rates(self) -> dict[str, float]:
        """Per-signature base arrival rate (pods/hour).  With a live
        chronological series: the EWMA over the group's counts per
        ABSOLUTE hour, walked oldest -> newest over the span the ring
        covers (gap hours count as zero, so an idle stretch decays the
        rate).  Without one (journal-loaded/merged table): the mean
        hourly rate, total / 24.  Always finite and >= 0 — an empty
        table is an empty dict, never NaN."""
        with self._lock:
            counts = {sig: list(row) for sig, row in self._counts.items()}
            series = None if self._series is None else list(self._series)
        if series:
            lo = min(h for _, h in series)
            hi = max(h for _, h in series)
            span = min(hi - lo + 1, 24 * 14)     # bounded walk (2 weeks)
            lo = hi - span + 1
            per_hour: dict[str, dict[int, int]] = {}
            for sig, h in series:
                if h >= lo:
                    d = per_hour.setdefault(sig, {})
                    d[h] = d.get(h, 0) + 1
            out: dict[str, float] = {}
            for sig, buckets in sorted(per_hour.items()):
                ewma = 0.0
                for h in range(lo, hi + 1):
                    ewma = EWMA_ALPHA * float(buckets.get(h, 0)) \
                        + (1.0 - EWMA_ALPHA) * ewma
                if ewma > 0.0:
                    out[sig] = ewma
            return out
        out = {}
        for sig, row in counts.items():
            mean = sum(row) / float(HOURS)
            if mean > 0.0:
                out[sig] = mean
        return out

    def diurnal(self) -> np.ndarray:
        """float64 [24] hour-of-day multipliers, mean 1.0: the observed
        global profile when the table has enough mass, the soak prior
        otherwise (and a count-weighted blend in between) — guarded so
        a cold or garbage-free ledger can never produce NaN."""
        prior = soak_diurnal_prior()
        with self._lock:
            rows = list(self._counts.values())
        if not rows:
            return prior
        totals = np.zeros(HOURS, dtype=np.float64)
        for row in rows:
            totals += np.asarray(row, dtype=np.float64)
        mass = float(totals.sum())
        if mass <= 0.0:
            return prior
        observed = totals * (HOURS / mass)
        # blend weight ramps with observed mass: ~HOURS arrivals is
        # still mostly prior, hundreds are mostly observation
        w = min(1.0, mass / (HOURS * 8.0))
        prof = w * observed + (1.0 - w) * prior
        return prof / max(float(prof.mean()), 1e-9)

    def expected_arrivals(self, horizon_hours: int,
                          start_hour: int = 0) -> dict[str, int]:
        """Expected arrivals per signature group over the next
        ``horizon_hours`` virtual hours starting after ``start_hour`` —
        the forecasted wave the scenario generator lowers onto the
        baseline's matching solve groups.  Deterministic rounding; an
        empty table forecasts nothing (the cold-ledger degenerate case
        the baseline-only scenario covers)."""
        prof = self.diurnal()
        scale = sum(float(prof[(start_hour + 1 + i) % HOURS])
                    for i in range(max(int(horizon_hours), 0)))
        out: dict[str, int] = {}
        for sig, rate in self.rates().items():
            n = int(round(rate * scale))
            if n > 0:
                out[sig] = n
        return out

    def snapshot(self) -> dict:
        """The /debug/whatif + /statusz forecast payload."""
        rates = self.rates()
        with self._lock:
            groups = len(self._counts)
            total = sum(sum(row) for row in self._counts.values())
        return {
            "generation": self.generation,
            "built_at": round(self.built_at, 3),
            "signature_groups": groups,
            "arrivals_observed": total,
            "top_rates": [
                {"signature": sig[:120], "pods_per_hour": round(r, 4)}
                for sig, r in sorted(rates.items(),
                                     key=lambda kv: (-kv[1], kv[0]))[:8]],
            "diurnal": [round(float(x), 4) for x in self.diurnal()],
        }

    # -- persistence (recovery journal state records) ----------------------

    def save(self, journal) -> None:
        """One keyed state record per signature group — newest-wins, so
        a restart rebuilds the exact table (recovery/journal.py, the
        spot-risk model's channel)."""
        with self._lock:
            counts = {sig: list(row) for sig, row in self._counts.items()}
        for sig, row in counts.items():
            digest = hashlib.blake2b(sig.encode(), digest_size=10).hexdigest()
            journal.state(f"{STATE_PREFIX}{digest}",
                          {"signature": sig, "counts": row})

    @classmethod
    def load(cls, journal) -> "ArrivalForecaster":
        model = cls()
        for key, value in journal.state_map().items():
            if not key.startswith(STATE_PREFIX) or not isinstance(value,
                                                                  dict):
                continue
            sig = value.get("signature")
            row = value.get("counts")
            if not isinstance(sig, str) or not isinstance(row, list):
                continue
            with model._lock:
                model._counts[sig] = [int(c) for c in row[:HOURS]] \
                    + [0] * max(0, HOURS - len(row))
        with model._lock:
            model.generation = _table_fingerprint(model._counts)
        return model
