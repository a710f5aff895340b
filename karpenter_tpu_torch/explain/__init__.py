"""Placement explainability: the reason-bit table and its fold.

Port of the constants and pure helpers of ``karpenter_tpu/explain``: the
per-group reason bitmask the device reduction computes
(``solver/packed.explain_words``), the most-specific-wins ladder that
folds a word into one canonical reason, and the deficit sentinels the
nearest-miss argmin shares with the host oracle (``explain/greedy.py``),
and the bounded per-pod registry behind ``/debug/explain``
(``ExplainRegistry``, ``get_registry``).
"""

from __future__ import annotations

import threading

from karpenter_tpu_torch.obs.trace import now

REASON_BITS = (
    ("insufficient_cpu", 0),        # no candidate offering has the CPU
    ("insufficient_mem", 1),        # .. the memory
    ("insufficient_accel", 2),      # .. the accelerators
    ("insufficient_pods", 3),       # .. the pod slots
    ("requirements", 4),            # label requirements match no offering
    ("taints", 5),                  # pool taints not tolerated (encode reject)
    ("zone_affinity", 6),           # zone requirement/pin eliminated all
    ("zone_blackout", 7),           # every allowed-zone candidate blacked out
    ("availability", 8),            # label matches exist but all unavailable
    ("preemption_budget", 9),       # preemption plane out of budget
    ("gang_geometry", 10),          # no torus hosts the gang's slice shape
    ("gang_parked", 11),            # parked awaiting gang min_member
    ("priority_starved", 12),       # preemption found no lower-prio victim
    ("capacity_higher_prio", 13),   # capacity consumed by higher priority
    ("capacity_exhausted", 14),     # feasible offerings exist, all consumed
    ("overcommit_risk", 15),        # the chance-constraint variance buffer
                                    # (karpenter_tpu/stochastic) blocked
                                    # density the mean alone would allow
    ("affinity_unsatisfied", 16),   # a required/anti (anti-)affinity edge
                                    # (karpenter_tpu/affinity) left no
                                    # placement for the group
    ("spread_bound", 17),           # a hostname topology-spread bound
                                    # clamped the group below its count
)

BIT = {name: idx for name, idx in REASON_BITS}
CANONICAL_REASONS = tuple(name for name, _ in REASON_BITS)

# bits the DEVICE reduction computes (solver/packed.explain_words;
# overcommit_risk by the stochastic kernel's reduction,
# stochastic/kernel._risk_words); everything else is host-refined or
# controller-stamped
DEVICE_BITS = frozenset((
    "insufficient_cpu", "insufficient_mem", "insufficient_accel",
    "insufficient_pods", "requirements", "capacity_higher_prio",
    "capacity_exhausted", "overcommit_risk", "affinity_unsatisfied",
    "spread_bound"))

# plane-level bits stamped by controllers (gang/preempt) rather than the
# solve: a fresh window verdict (registry.note merge=False) REPLACES the
# solver-owned bits but PRESERVES these — otherwise every solve window
# would wipe the preemption plane's stamp, the canonical fold would flap
# between the two verdicts, and the "reason changed" event dedupe would
# fire twice per reconcile cycle forever.  Controllers clear their own
# bits when their verdict lifts (gang admit/release).
PLANE_REASONS = ("preemption_budget", "gang_geometry", "gang_parked",
                 "priority_starved")

# Most-specific-wins ladder: the FIRST set bit in this order is the
# canonical reason.  Plane-level verdicts (gang/preempt) outrank the
# static split, which outranks resource insufficiency, which outranks
# the capacity catch-alls.
LADDER = (
    "gang_parked",
    "gang_geometry",
    "preemption_budget",
    "priority_starved",
    "taints",
    "zone_blackout",
    "zone_affinity",
    "availability",
    "requirements",
    "insufficient_accel",
    "insufficient_pods",
    "insufficient_mem",
    "insufficient_cpu",
    # affinity verdicts rank below genuine resource insufficiency (an
    # offering that can't hold the pod beats any edge story) but above
    # the capacity catch-alls: "your required edge had no co-resident
    # target" beats "everything was consumed"
    "affinity_unsatisfied",
    "spread_bound",
    # the variance buffer is more specific than the capacity catch-alls:
    # "your p99 usage blocked this" beats "everything was consumed"
    "overcommit_risk",
    "capacity_higher_prio",
    "capacity_exhausted",
)

assert set(LADDER) == set(CANONICAL_REASONS), "reason-enum drift"

# per-dim deficit clip shared by the device reduction and the host
# oracle: sum of 4 clipped dims stays < 2^31, so the nearest-miss argmin
# is integer-exact on both sides
DEFICIT_CLIP = 1 << 28
# masked (label-incompatible) deficit sentinel — strictly above any real
# clipped total so a masked offering can never win the argmin tie-break
DEFICIT_MASKED = (1 << 30) + 1

RESOURCE_BITS = ("insufficient_cpu", "insufficient_mem",
                 "insufficient_accel", "insufficient_pods")
RESOURCE_NAMES = ("cpu_milli", "memory_mib", "accel", "pod_slots")


def word_for(*names: str) -> int:
    """Pack reason names into a bitmask word."""
    w = 0
    for n in names:
        w |= 1 << BIT[n]
    return w


def word_names(word: int) -> list[str]:
    """Every reason name set in ``word``, in bit order."""
    return [name for name, idx in REASON_BITS if word & (1 << idx)]


def fold_reason(word: int) -> str:
    """Most-specific-wins fold: ONE canonical reason for a word.
    A zero word (no evidence recorded) folds to the capacity catch-all —
    a pod can only be unplaced with a zero word when every static check
    passed and the solve ran out of room for it."""
    for name in LADDER:
        if word & (1 << BIT[name]):
            return name
    return "capacity_exhausted"


class ExplainEntry:
    """One pod's last-known elimination evidence (bounded registry row)."""

    __slots__ = ("pod", "word", "reason", "detail", "nearest", "trace_id",
                 "updated_at")

    def __init__(self, pod: str):
        self.pod = pod
        self.word = 0
        self.reason = ""
        self.detail = ""
        self.nearest: dict | None = None
        self.trace_id = 0
        self.updated_at = 0.0

    def to_dict(self) -> dict:
        out = {
            "pod": self.pod,
            "reason": self.reason,
            "word": self.word,
            "bits": word_names(self.word),
            "detail": self.detail,
            "trace_id": self.trace_id,
            "updated_at": round(self.updated_at, 6),
        }
        if self.nearest is not None:
            out["nearest_miss"] = self.nearest
        return out


class ExplainRegistry:
    """Bounded last-reason-per-pod table behind ``/debug/explain``.

    Same design rules as the ledger: stamps are a dict update under a
    lock, the table is FIFO-bounded, and resolution prunes the row so
    the surface only describes pods that are still unplaced."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: dict[str, ExplainEntry] = {}
        self.stamped_total = 0

    def note(self, pod: str, word: int, reason: str, *, detail: str = "",
             nearest: dict | None = None, trace_id: int = 0,
             merge: bool = True) -> bool:
        """Record one pod's evidence; returns True when the canonical
        reason CHANGED (the event-dedup signal).  ``merge`` ORs the word
        into the existing evidence (controller stamps layer on top of
        the solver's word); a fresh solve verdict passes merge=False,
        which replaces the solver-owned bits but preserves the
        controller planes' (PLANE_REASONS) until their owners clear
        them."""
        plane_mask = word_for(*PLANE_REASONS)
        with self._lock:
            entry = self._entries.get(pod)
            if entry is None:
                while len(self._entries) >= self.capacity:
                    self._entries.pop(next(iter(self._entries)))
                entry = self._entries[pod] = ExplainEntry(pod)
            prev = entry.reason
            entry.word = (entry.word | word) if merge \
                else (entry.word & plane_mask) | word
            entry.reason = fold_reason(entry.word) \
                if entry.word & plane_mask else (reason
                                                 or fold_reason(entry.word))
            if detail:
                entry.detail = detail
            if nearest is not None:
                entry.nearest = nearest
            if trace_id:
                entry.trace_id = trace_id
            entry.updated_at = now()
            self.stamped_total += 1
            return entry.reason != prev

    def stamp(self, pod: str, reason: str, *, detail: str = "",
              trace_id: int = 0) -> bool:
        """Controller-plane stamp of one named reason bit (gang_parked,
        preemption_budget, ...).  Returns True when the fold changed."""
        return self.note(pod, word_for(reason), "", detail=detail,
                         trace_id=trace_id, merge=True)

    def clear_bits(self, pod: str, *reasons: str) -> None:
        """A plane's verdict lifted (gang admitted, budget restored):
        drop those bits and re-fold.  Never emits a change signal — the
        next authoritative verdict owns the event."""
        mask = ~word_for(*reasons)
        with self._lock:
            entry = self._entries.get(pod)
            if entry is None:
                return
            entry.word &= mask
            if entry.word == 0:
                self._entries.pop(pod, None)
            else:
                entry.reason = fold_reason(entry.word)

    def resolve(self, pod: str) -> None:
        """The pod placed (or left the cluster): drop its row."""
        with self._lock:
            self._entries.pop(pod, None)

    def get(self, pod: str) -> ExplainEntry | None:
        with self._lock:
            return self._entries.get(pod)

    def entries(self, limit: int | None = None) -> list[ExplainEntry]:
        with self._lock:
            rows = list(self._entries.values())
        rows.sort(key=lambda e: -e.updated_at)
        return rows if limit is None else rows[:limit]

    def summary(self) -> dict[str, int]:
        """reason -> count over the current table (the /statusz block)."""
        out: dict[str, int] = {}
        with self._lock:
            for e in self._entries.values():
                out[e.reason] = out.get(e.reason, 0) + 1
        return out

    def update_unplaced_gauge(self) -> None:
        """Refresh ``karpenter_tpu_unplaced_pods{reason}`` over the FULL
        allowlist (absent reasons render 0 — dashboards never see a
        stale count linger after the last pod of a reason places)."""
        from karpenter_tpu_torch.utils import metrics

        counts = self.summary()
        for reason in CANONICAL_REASONS:
            metrics.UNPLACED_PODS.labels(reason).set(counts.get(reason, 0))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.stamped_total = 0


_REGISTRY = ExplainRegistry()


def get_registry() -> ExplainRegistry:
    return _REGISTRY
