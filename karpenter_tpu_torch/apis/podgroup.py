"""Gang-scheduling API: the PodGroup a pending pod may belong to.

The workloads a TPU provisioner actually serves are multi-host
pjit/pallas jobs: N replicas that are useless unless *all* of them land,
and land on a *contiguous slice* of the right torus shape.  A
:class:`PodGroup` is the demand-side declaration of that contract
(the k8s coscheduling PodGroup / JobSet analogue):

- ``name``        — the group key; every member pod carries the same one;
- ``min_member``  — admission threshold: the gang enters the provision
                    queue only once this many members are pending
                    (controllers/gang.py parks it until then);
- ``slice_shape`` — optional torus sub-slice the gang needs, parsed from
                    ``"4x4"`` / ``"2x2x2"`` strings (gang/topology.py
                    lowers it to placement bitmasks over the catalog's
                    per-type tori);
- ``deadline_seconds`` — how long a sub-``min_member`` gang may sit
                    parked before the controller releases its members
                    as ordinary per-pod work (degraded fallback).

Validation is strict and happens in ``__post_init__`` — a malformed
group spec must never silently become "no gang" (the member pods would
place per-pod and the job would deadlock at runtime instead of at
admission).  The tuple from :meth:`PodGroup.signature` folds into the
pod constraint signature exactly like ``priority`` did, so gang members
never share an encode group with non-members.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

# torus sub-slices are at most 3-D (TPU pod slices are 2-D/3-D tori) and
# every axis is a small positive int.  64 chips is the largest torus the
# topology layer's single-word chip bitmasks represent (gang/topology.py)
# — a shape that cannot be represented must be rejected at admission,
# never become a silently-unplaceable-forever gang.
MAX_SLICE_DIMS = 3
MAX_SLICE_CHIPS = 64

_SLICE_RE = re.compile(r"^[0-9]+(x[0-9]+){0,%d}$" % (MAX_SLICE_DIMS - 1))


def parse_slice_shape(q) -> tuple[int, ...] | None:
    """``"4x4"`` -> ``(4, 4)``; ``None``/``""`` -> ``None``.

    Accepts a string, a tuple/list of ints, or None.  Anything else —
    zero axes, non-positive axes, more than :data:`MAX_SLICE_DIMS`
    dims — hard-rejects: the shape feeds straight into the topology
    layer's bitmask enumeration, and a lenient parse would turn a typo'd
    manifest into an unplaceable-forever gang with no admission error.
    """
    if q is None or q == "":
        return None
    if isinstance(q, str):
        s = q.strip().lower()
        if not _SLICE_RE.match(s):
            raise ValueError(f"bad slice shape {q!r}: want 'AxB' / 'AxBxC'")
        dims = tuple(int(d) for d in s.split("x"))
    elif isinstance(q, (tuple, list)):
        dims = tuple(q)
    else:
        raise ValueError(f"bad slice shape {q!r}: must be str or tuple")
    if not dims or len(dims) > MAX_SLICE_DIMS:
        raise ValueError(f"bad slice shape {q!r}: 1..{MAX_SLICE_DIMS} dims")
    for d in dims:
        if isinstance(d, bool) or not isinstance(d, int) or d < 1:
            raise ValueError(f"bad slice shape {q!r}: axes must be ints >= 1")
    if math.prod(dims) > MAX_SLICE_CHIPS:
        raise ValueError(f"bad slice shape {q!r}: > {MAX_SLICE_CHIPS} chips")
    return dims


@dataclass(frozen=True)
class PodGroup:
    """One gang's contract: group key + admission + topology demand."""

    name: str
    min_member: int = 1
    slice_shape: tuple[int, ...] | None = None
    deadline_seconds: float = 120.0

    def __post_init__(self):
        if not isinstance(self.name, str) or not self.name:
            raise ValueError(f"bad gang name {self.name!r}: non-empty str")
        mm = self.min_member
        if isinstance(mm, bool) or not isinstance(mm, int) or mm < 1:
            raise ValueError(f"bad gang min_member {mm!r}: int >= 1")
        object.__setattr__(self, "slice_shape",
                           parse_slice_shape(self.slice_shape))
        dl = self.deadline_seconds
        if isinstance(dl, bool) or not isinstance(dl, (int, float)) \
                or not math.isfinite(dl) or dl <= 0:
            raise ValueError(f"bad gang deadline {dl!r}: finite seconds > 0")
        object.__setattr__(self, "deadline_seconds", float(dl))

    @property
    def chips(self) -> int:
        """Torus chips the slice occupies (0 = no topology demand)."""
        return math.prod(self.slice_shape) if self.slice_shape else 0

    def signature(self) -> tuple:
        """The constraint-signature component: pods of different gangs
        (or different gang contracts) are never interchangeable."""
        return (self.name, self.min_member, self.slice_shape)
