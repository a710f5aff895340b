"""Placement explainability: the reason-bit table and its fold.

Port of the constants and pure helpers of ``karpenter_tpu/explain``: the
per-group reason bitmask the device reduction computes
(``solver/packed.explain_words``), the most-specific-wins ladder that
folds a word into one canonical reason, and the deficit sentinels the
nearest-miss argmin shares with the host oracle (``explain/greedy.py``).
The per-pod registry behind ``/debug/explain`` belongs to the controller
layer and is not carried here.
"""

from __future__ import annotations

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


def fold_reason(word: int) -> str:
    """Most-specific-wins fold: ONE canonical reason for a word.
    A zero word (no evidence recorded) folds to the capacity catch-all —
    a pod can only be unplaced with a zero word when every static check
    passed and the solve ran out of room for it."""
    for name in LADDER:
        if word & (1 << BIT[name]):
            return name
    return "capacity_exhausted"
