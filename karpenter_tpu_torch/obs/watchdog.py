"""Anomaly watchdog: EWMA baselines over sampled device timings +
recompile-burst detection, emitting rate-limited triage bundles (port of
``karpenter_tpu/obs/watchdog.py``).

The profiler (obs/prof.py) feeds every sampled (kernel, phase) duration
into rolling EWMA baselines (mean + mean absolute deviation).  A sample
that lands far outside its baseline — after a warmup count, above an
absolute floor, and beyond both a ratio and a deviation-multiple bound —
is a **breach**: the tail event the host-side phase histograms
structurally cannot attribute (a slow bucket could be tunnel, chip, or
host; the sampled split says which).  A burst of jit recompiles inside
a rolling window (devtel's ``recompile_sink``) breaches the same way:
recompile storms are the classic silent solve-latency cliff.

A breach triggers a **triage bundle**: one directory under ``.triage/``
holding the flight-recorder span bundle, the placement ledger's worst-K
table, the devtel/resident snapshot, the profiler split, and the breach
detail — everything an operator needs to answer "what just got slow"
without reproducing it.  Bundles are:

- **rate-limited** (one per ``rate_limit_s`` on the obs clock — which
  the chaos VirtualClock patches, so suppression windows are
  deterministic under virtual time);
- **size-bounded** (span dump capped at ``MAX_BUNDLE_SPANS`` lines,
  worst-K at 16 rows) and **FIFO-capped** (oldest bundle directories
  pruned past ``max_bundles``);
- **counted** (``karpenter_tpu_watchdog_breaches_total{kernel,phase}``,
  ``karpenter_tpu_triage_bundles_total{trigger}``,
  ``karpenter_tpu_watchdog_suppressed_total{trigger}``).

Baselines deliberately do NOT absorb breach samples: an anomaly must
not poison the mean it was judged against (a sustained slowdown keeps
breaching; the rate limit keeps the disk quiet).

``chaos/soak.py`` reuses :func:`write_triage_bundle` directly: an SLO
burn in ``make soak`` / ``soak-short`` writes a bundle next to the burn
report, and CI uploads ``.triage/`` as an artifact.  An optional
``torch.profiler`` Chrome trace (``torch-trace.json``) rides along when
``KARPENTER_TRIAGE_JAX_TRACE=1``, the reference's gate (best-effort — a
profiling failure must never fail the bundle).  See docs/design/profiling.md.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import time
from collections import deque
from pathlib import Path

from karpenter_tpu_torch.obs.trace import now
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("obs.watchdog")

DEFAULT_TRIAGE_DIR = os.environ.get("KARPENTER_TRIAGE_DIR", ".triage")
MAX_BUNDLE_SPANS = 5000
MAX_BUNDLE_WORST = 16

_BUNDLE_SEQ = itertools.count(1)


class Baseline:
    """Rolling EWMA of a (kernel, phase) duration stream: mean + mean
    absolute deviation (cheaper and more outlier-robust than EWM
    variance at these sample rates)."""

    __slots__ = ("mean", "dev", "n")
    ALPHA = 0.2

    def __init__(self):
        self.mean = 0.0
        self.dev = 0.0
        self.n = 0

    def update(self, x: float) -> None:
        if self.n == 0:
            self.mean = x
        else:
            self.dev += self.ALPHA * (abs(x - self.mean) - self.dev)
            self.mean += self.ALPHA * (x - self.mean)
        self.n += 1


class Watchdog:
    """Per-process anomaly detector over the profiler's sample stream."""

    WARMUP = 5              # samples before a baseline can breach
    DEV_MULT = 6.0          # breach: > mean + DEV_MULT * dev ...
    MIN_RATIO = 2.0         # ... AND > MIN_RATIO * mean ...
    MIN_ABS_S = 0.001       # ... AND over an absolute floor (sub-ms
    #                         wobble on a fast kernel is noise, not an
    #                         anomaly worth a bundle)
    RECOMPILE_BURST = 8     # recompiles inside the window that breach
    RECOMPILE_WINDOW_S = 60.0
    # the burst detector arms AFTER a grace period: a fresh process
    # compiling its kernel set is a cold start, not an anomaly — the
    # page-worthy signal is a recompile storm in a WARM process
    # (catalog churn exploding the shape buckets)
    RECOMPILE_GRACE_S = 120.0
    # solver-quality regression (obs/telemetry_words feeds every decoded
    # window's fill here): a window whose fill collapses below
    # QUALITY_COLLAPSE x the plane's EWMA baseline — provided the
    # baseline itself is meaningful (>= QUALITY_MIN_BASELINE_BP; a
    # near-empty fleet "collapsing" to empty is not a regression) —
    # after QUALITY_WARMUP windows.  Escalation re-dispatches burst the
    # way recompiles do: ESCALATION_BURST inside the rolling window.
    QUALITY_WARMUP = 8
    QUALITY_COLLAPSE = 0.5
    QUALITY_MIN_BASELINE_BP = 1000
    ESCALATION_BURST = 8
    ESCALATION_WINDOW_S = 60.0

    def __init__(self, *, triage_dir: str | None = None,
                 rate_limit_s: float = 300.0, max_bundles: int = 8,
                 warmup: int | None = None,
                 recompile_grace_s: float | None = None):
        self.triage_dir = triage_dir or DEFAULT_TRIAGE_DIR
        self.rate_limit_s = rate_limit_s
        self.max_bundles = max_bundles
        self.warmup = self.WARMUP if warmup is None else warmup
        self._armed_at = now() + (
            self.RECOMPILE_GRACE_S if recompile_grace_s is None
            else recompile_grace_s)
        self._lock = threading.Lock()
        self._baselines: dict[tuple[str, str], Baseline] = {}
        self._recompiles: deque[float] = deque()
        # solver-quality state (telemetry words): per-plane fill EWMA +
        # a rolling escalation-event window shaped like the recompile one
        self._quality: dict[str, Baseline] = {}
        self._escalations: deque[float] = deque()
        self._last_bundle_t: float | None = None
        self.breaches = 0
        self.bundles = 0
        self.suppressed = 0
        self.last_breach: dict = {}
        self.last_bundle_path = ""

    # -- detection -----------------------------------------------------------

    def observe(self, kernel: str, phase: str, value: float) -> bool:
        """One sampled duration.  Returns True when it breached (a
        bundle may or may not have been written — the rate limit
        decides)."""
        with self._lock:
            b = self._baselines.setdefault((kernel, phase), Baseline())
            breach = (b.n >= self.warmup
                      and value >= self.MIN_ABS_S
                      and value > b.mean * self.MIN_RATIO
                      and value > b.mean + self.DEV_MULT * b.dev)
            detail = None
            if breach:
                self.breaches += 1
                detail = {
                    "kernel": kernel, "phase": phase,
                    "value_s": round(value, 6),
                    "baseline_mean_s": round(b.mean, 6),
                    "baseline_dev_s": round(b.dev, 6),
                    "baseline_n": b.n,
                }
                self.last_breach = detail
            else:
                # breach samples never update the baseline they were
                # judged against (an anomaly must not raise the bar for
                # the next one)
                b.update(value)
        if detail is not None:
            metrics.WATCHDOG_BREACHES.labels(kernel, phase).inc()
            self.trigger("slow_kernel", detail)
        return detail is not None

    def note_recompile(self, kernel: str) -> bool:
        """One jit recompile event (devtel recompile_sink).  A burst of
        RECOMPILE_BURST inside the rolling window breaches — and resets
        the window so a sustained storm re-arms instead of re-firing
        per event.  Events inside the cold-start grace period are
        recorded but never breach (a fresh process compiling its
        kernels is normal)."""
        t = now()
        with self._lock:
            self._recompiles.append(t)
            cutoff = t - self.RECOMPILE_WINDOW_S
            while self._recompiles and self._recompiles[0] < cutoff:
                self._recompiles.popleft()
            burst = t >= self._armed_at \
                and len(self._recompiles) >= self.RECOMPILE_BURST
            if burst:
                count = len(self._recompiles)
                self._recompiles.clear()
                self.breaches += 1
                detail = {"kernel": kernel, "recompiles_in_window": count,
                          "window_s": self.RECOMPILE_WINDOW_S}
                self.last_breach = detail
        if burst:
            metrics.WATCHDOG_BREACHES.labels(kernel, "recompile").inc()
            self.trigger("recompile_burst", detail)
        return burst

    def note_quality(self, plane: str, fill_bp: int, *,
                     escalations: int = 0) -> bool:
        """One decoded solve window's quality telemetry
        (obs/telemetry_words.record_window).  Two detectors:

        - **fill collapse** — the window's dominant fill fraction (basis
          points) lands below QUALITY_COLLAPSE x the plane's EWMA
          baseline while the baseline is meaningful: the solver suddenly
          packs far worse than it just did (a constraint encoding bug, a
          catalog regression, a quietly degraded lane) even though every
          latency metric looks healthy.
        - **escalation burst** — ESCALATION_BURST host-side re-dispatch
          retries (node escalation / COO growth) inside the rolling
          window: each retry re-pays the full dispatch RTT, so a storm
          is a latency cliff with a solver-shaped cause.

        Returns True when either breached.  Breach windows never update
        the baseline they were judged against (the slow_kernel rule)."""
        t = now()
        qdetail = edetail = None
        with self._lock:
            b = self._quality.setdefault(plane, Baseline())
            collapse = (b.n >= self.QUALITY_WARMUP
                        and b.mean >= self.QUALITY_MIN_BASELINE_BP
                        and fill_bp < b.mean * self.QUALITY_COLLAPSE)
            if collapse:
                self.breaches += 1
                qdetail = {
                    "plane": plane, "fill_bp": int(fill_bp),
                    "baseline_mean_bp": round(b.mean, 1),
                    "baseline_n": b.n,
                    "collapse_ratio": self.QUALITY_COLLAPSE,
                }
                self.last_breach = qdetail
            else:
                b.update(float(fill_bp))
            if escalations:
                self._escalations.extend([t] * min(int(escalations), 64))
                cutoff = t - self.ESCALATION_WINDOW_S
                while self._escalations and self._escalations[0] < cutoff:
                    self._escalations.popleft()
                if len(self._escalations) >= self.ESCALATION_BURST:
                    count = len(self._escalations)
                    self._escalations.clear()
                    self.breaches += 1
                    edetail = {"plane": plane,
                               "escalations_in_window": count,
                               "window_s": self.ESCALATION_WINDOW_S}
                    self.last_breach = edetail
        if qdetail is not None:
            metrics.WATCHDOG_BREACHES.labels(plane, "quality").inc()
            self.trigger("quality_regression", qdetail)
        if edetail is not None:
            metrics.WATCHDOG_BREACHES.labels(plane, "escalation").inc()
            self.trigger("escalation_burst", edetail)
        return qdetail is not None or edetail is not None

    # -- bundle emission -----------------------------------------------------

    def trigger(self, trigger: str, detail: dict) -> str | None:
        """Rate-limited bundle write.  Returns the bundle path, or None
        when suppressed (or the write failed — a watchdog must never
        take down the path it watches)."""
        with self._lock:
            t = now()
            if self._last_bundle_t is not None \
                    and t - self._last_bundle_t < self.rate_limit_s:
                self.suppressed += 1
                metrics.WATCHDOG_SUPPRESSED.labels(trigger).inc()
                return None
            self._last_bundle_t = t
        try:
            path = write_triage_bundle(
                trigger, detail, triage_dir=self.triage_dir,
                max_bundles=self.max_bundles)
        except Exception as e:  # noqa: BLE001 — never fail the solve path
            log.warning("triage bundle write failed", trigger=trigger,
                        error=str(e)[:200])
            metrics.ERRORS.labels("watchdog", "bundle_write").inc()
            return None
        with self._lock:
            self.bundles += 1
            self.last_bundle_path = path
        metrics.TRIAGE_BUNDLES.labels(trigger).inc()
        return path

    # -- readout -------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "breaches": self.breaches,
                "bundles": self.bundles,
                "suppressed": self.suppressed,
                "baselines": len(self._baselines),
                "quality_baselines": len(self._quality),
                "recompile_burst_armed": now() >= self._armed_at,
                "rate_limit_s": self.rate_limit_s,
                "max_bundles": self.max_bundles,
                "triage_dir": self.triage_dir,
                "last_breach": dict(self.last_breach),
                "last_bundle": self.last_bundle_path,
            }

    def reset(self) -> None:
        with self._lock:
            self._baselines.clear()
            self._recompiles.clear()
            self._quality.clear()
            self._escalations.clear()
            self._last_bundle_t = None
            self.breaches = self.bundles = self.suppressed = 0
            self.last_breach = {}
            self.last_bundle_path = ""


def write_triage_bundle(trigger: str, detail: dict, *,
                        triage_dir: str = DEFAULT_TRIAGE_DIR,
                        max_bundles: int = 8,
                        recorder=None, ledger=None,
                        extra: dict | None = None) -> str:
    """One self-contained triage directory:

    - ``bundle.json`` — trigger + detail, the ledger worst-K table
      (trace ids link into the span dump), ledger/devtel/resident/
      profiler/watchdog snapshots, optional caller extras;
    - ``spans.jsonl`` — the flight recorder's retained span bundle
      (size-capped), same wire format as the chaos violation artifact
      and convertible to Perfetto via ``python -m karpenter_tpu_torch.obs
      export --input``.

    FIFO-capped: bundle directories past ``max_bundles`` are pruned
    oldest-first (directory names sort by write order)."""
    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.obs.devtel import get_devtel
    from karpenter_tpu_torch.obs.export import dump_jsonl, recorder_to_dicts
    from karpenter_tpu_torch.obs.prof import get_profiler

    recorder = recorder or obs.get_recorder()
    ledger = ledger or obs.get_ledger()
    seq = next(_BUNDLE_SEQ)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(time.time()))
    bdir = Path(triage_dir) / f"{stamp}-{seq:04d}-{trigger}"
    bdir.mkdir(parents=True, exist_ok=True)
    spans = recorder_to_dicts(recorder)[:MAX_BUNDLE_SPANS]
    dump_jsonl(spans, bdir / "spans.jsonl")
    manifest = {
        "trigger": trigger,
        "detail": detail,
        "written_at": time.time(),
        "span_count": len(spans),
        "worst_pods": ledger.worst()[:MAX_BUNDLE_WORST],
        "ledger": ledger.stats(),
        "device_telemetry": get_devtel().snapshot(),
        "profiler": get_profiler().snapshot(),
        "watchdog": get_watchdog().snapshot(),
    }
    if extra:
        manifest.update(extra)
    _maybe_torch_trace(bdir)
    (bdir / "bundle.json").write_text(
        json.dumps(manifest, indent=2, default=str, sort_keys=True) + "\n")
    _prune_fifo(Path(triage_dir), max_bundles)
    return str(bdir)


def _maybe_torch_trace(bdir: Path) -> None:
    """Optional ``torch.profiler`` Chrome trace into the bundle — env-
    gated as the reference's ``jax.profiler`` trace is (a device trace
    is heavy and needs live dispatches to be useful) and best-effort (a
    profiler session already running must not fail the bundle)."""
    if os.environ.get("KARPENTER_TRIAGE_JAX_TRACE") != "1":
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            time.sleep(0.25)
        prof.export_chrome_trace(str(bdir / "torch-trace.json"))
    except Exception as e:  # noqa: BLE001 — best-effort extra evidence
        log.warning("triage torch trace failed", error=str(e)[:200])


def _prune_fifo(root: Path, max_bundles: int) -> None:
    if not root.is_dir():
        return
    dirs = sorted(p for p in root.iterdir() if p.is_dir())
    for stale in dirs[:max(0, len(dirs) - max_bundles)]:
        shutil.rmtree(stale, ignore_errors=True)


# process-wide singleton (same rationale as devtel/prof: one anomaly
# ledger across every dispatch site)
_WATCHDOG: Watchdog | None = None
_SINGLETON_LOCK = threading.Lock()


def get_watchdog() -> Watchdog:
    global _WATCHDOG
    if _WATCHDOG is None:
        with _SINGLETON_LOCK:
            if _WATCHDOG is None:
                _WATCHDOG = Watchdog()
    return _WATCHDOG
