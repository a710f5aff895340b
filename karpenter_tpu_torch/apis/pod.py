"""Pod-side scheduling inputs: requests, tolerations, spread, affinity.

These are the *demand* half of the placement problem.  Resource quantities
are normalized to integer units at parse time (milliCPU, MiB, GPU count,
one pod slot) so the device solve is exact integer arithmetic — no float
floor-division hazards on the device.
"""

from __future__ import annotations

import math
import re
import threading
from dataclasses import dataclass, field

from karpenter_tpu_torch.apis.podgroup import PodGroup
from karpenter_tpu_torch.apis.requirements import Requirements

# Resource axis order used by every dense tensor in the system.
RESOURCE_AXES = ("cpu", "memory", "gpu", "pods")
NUM_RESOURCES = len(RESOURCE_AXES)

_QTY_RE = re.compile(r"^([0-9]*\.?[0-9]+)([a-zA-Z]*)$")

_MEM_MULT = {  # to MiB
    "": 1 / (1024 * 1024), "k": 1000 / (1024 * 1024), "M": 1000_000 / (1024 * 1024),
    "G": 1e9 / (1024 * 1024), "T": 1e12 / (1024 * 1024),
    "Ki": 1 / 1024, "Mi": 1.0, "Gi": 1024.0, "Ti": 1024.0 * 1024,
}


def parse_cpu_milli(q) -> int:
    """'500m' -> 500; '2' -> 2000; 1.5 -> 1500."""
    if isinstance(q, (int, float)):
        return int(round(q * 1000))
    m = _QTY_RE.match(q.strip())
    if not m:
        raise ValueError(f"bad cpu quantity {q!r}")
    num, suffix = float(m.group(1)), m.group(2)
    if suffix == "m":
        return int(round(num))
    if suffix == "":
        return int(round(num * 1000))
    raise ValueError(f"bad cpu suffix {q!r}")


# k8s PriorityClass bounds: the API type is int32, and user-defined
# classes are capped at 1e9 (values above are reserved for
# system-critical classes) — out-of-range ints CLAMP (a cluster admin's
# oversized class must not reject the pod), non-ints REJECT (a typo'd
# priorityClassName resolution bug must not silently become priority 0).
PRIORITY_MIN = -(2 ** 31)
PRIORITY_MAX = 10 ** 9


def parse_priority(q) -> int:
    """Strict priorityClassName-style value: int (or None) -> clamped int.

    None -> 0 (no priority class).  bools, floats, and strings are
    rejected — priority feeds straight into the solver's int32
    ``group_prio`` tensor and the preemption planner's no-inversion
    guarantee, so a lenient parse here would let a malformed manifest
    silently outrank (or be outranked by) every correct pod."""
    if q is None:
        return 0
    if isinstance(q, bool) or not isinstance(q, int):
        raise ValueError(f"bad priority {q!r}: must be an int")
    return max(PRIORITY_MIN, min(PRIORITY_MAX, q))


def parse_memory_mib(q) -> int:
    """'4Gi' -> 4096; '512Mi' -> 512; bytes int -> MiB.

    Rounds *up* so sub-MiB requests never vanish from capacity accounting
    (a request of '512Ki' must cost 1 MiB, not 0).
    """
    if isinstance(q, (int, float)):
        return int(math.ceil(q / (1024 * 1024)))
    m = _QTY_RE.match(q.strip())
    if not m:
        raise ValueError(f"bad memory quantity {q!r}")
    num, suffix = float(m.group(1)), m.group(2)
    if suffix not in _MEM_MULT:
        raise ValueError(f"bad memory suffix {q!r}")
    return int(math.ceil(num * _MEM_MULT[suffix] - 1e-9))


@dataclass(frozen=True)
class ResourceRequests:
    """Integer-normalized resource vector (cpu milli, memory MiB, gpu, pods)."""

    cpu_milli: int = 0
    memory_mib: int = 0
    gpu: int = 0
    pods: int = 1

    @classmethod
    def parse(cls, requests: dict[str, object]) -> "ResourceRequests":
        return cls(
            cpu_milli=parse_cpu_milli(requests.get("cpu", 0)),
            memory_mib=parse_memory_mib(requests.get("memory", 0)),
            gpu=int(requests.get("nvidia.com/gpu", requests.get("gpu", 0)) or 0),
            pods=1,
        )

    def as_tuple(self) -> tuple[int, int, int, int]:
        return (self.cpu_milli, self.memory_mib, self.gpu, self.pods)

    def __add__(self, other: "ResourceRequests") -> "ResourceRequests":
        return ResourceRequests(self.cpu_milli + other.cpu_milli,
                                self.memory_mib + other.memory_mib,
                                self.gpu + other.gpu,
                                self.pods + other.pods)


# usage scalars feed straight into int32 device tensors
# (stochastic/encode.stack_usage) — a value past this bound would crash
# the encode or silently wrap to a NEGATIVE variance, voiding the
# violation bound, so it hard-rejects here instead
USAGE_MAX = 2 ** 31 - 1


def _usage_int(v, what: str) -> int:
    """parse_priority-style strictness for one usage scalar: ints only
    (bools and floats REJECT — a float mean would silently break the
    solver's exact integer mean arithmetic; NaN/inf literals arrive as
    floats and reject on the same branch), non-negative, int32-bounded
    (the dense tensors the solver consumes are int32)."""
    if isinstance(v, bool) or not isinstance(v, int):
        raise ValueError(f"bad usage {what} {v!r}: must be a "
                         f"non-negative int")
    if not 0 <= v <= USAGE_MAX:
        raise ValueError(f"bad usage {what} {v!r}: must be in "
                         f"[0, {USAGE_MAX}] (int32 tensor bound)")
    return v


@dataclass(frozen=True)
class UsageDistribution:
    """Per-resource usage distribution for chance-constrained packing
    (karpenter_tpu/stochastic): ``mean`` in the SAME integer units as
    :class:`ResourceRequests` (milliCPU, MiB, accel, pod slots) and
    ``var`` in those units SQUARED, both per pod.  A pod without a
    distribution behaves exactly as ``usage=(requests, 0)`` — the
    stochastic plane is a strict superset of deterministic packing.

    Validation is hard-reject at construction (the parse_priority
    convention): negative variance, variance on an axis whose mean is
    zero ("variance without mean"), and non-int values (bools, floats —
    which is also how NaN/inf are rejected) never enter the system, so
    the solver's quantile check can assume finite non-negative integers
    and never re-validates.
    """

    mean: ResourceRequests = field(default_factory=ResourceRequests)
    var: tuple[int, int, int, int] = (0, 0, 0, 0)

    def __post_init__(self):
        if not isinstance(self.mean, ResourceRequests):
            raise ValueError(f"bad usage mean {self.mean!r}: must be a "
                             f"ResourceRequests")
        mean = tuple(_usage_int(v, "mean") for v in self.mean.as_tuple())
        if not isinstance(self.var, (tuple, list)) \
                or len(self.var) != NUM_RESOURCES:
            raise ValueError(f"bad usage variance {self.var!r}: must be "
                             f"a {NUM_RESOURCES}-tuple")
        var = tuple(_usage_int(v, "variance") for v in self.var)
        for m, v, axis in zip(mean, var, RESOURCE_AXES):
            if v > 0 and m == 0:
                raise ValueError(
                    f"bad usage: variance {v} on {axis} with zero mean "
                    f"(variance without mean)")
        object.__setattr__(self, "var", var)

    def signature(self) -> tuple:
        return (self.mean.as_tuple(), self.var)


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass(frozen=True)
class Toleration:
    key: str = ""               # "" + Exists tolerates everything
    operator: str = "Equal"     # Equal | Exists
    value: str = ""
    effect: str = ""            # "" matches all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


def tolerates_all(tolerations: tuple[Toleration, ...], taints: tuple[Taint, ...]) -> bool:
    """A pod can schedule onto a node iff every NoSchedule/NoExecute taint is
    tolerated (PreferNoSchedule is soft and ignored for feasibility)."""
    for t in taints:
        if t.effect == "PreferNoSchedule":
            continue
        if not any(tol.tolerates(t) for tol in tolerations):
            return False
    return True


def tolerates_soft(tolerations: tuple[Toleration, ...],
                   taints: tuple[Taint, ...]) -> bool:
    """PreferNoSchedule counterpart of :func:`tolerates_all`: True when
    every SOFT taint is tolerated.  Used for pool-preference ordering
    (the provisioner tries soft-tainted pools last for intolerant pods),
    never for feasibility — kube semantics: 'prefer not to schedule,
    but allow'."""
    for t in taints:
        if t.effect != "PreferNoSchedule":
            continue
        if not any(tol.tolerates(t) for tol in tolerations):
            return False
    return True


# The two topology domains the solver models (node = offering slot,
# zone = catalog zone).  Any other key is a hard reject: a typo'd
# topology_key must not silently degrade to "no constraint".
HOSTNAME_TOPOLOGY_KEY = "kubernetes.io/hostname"
ZONE_TOPOLOGY_KEY = "topology.kubernetes.io/zone"
TOPOLOGY_KEYS = frozenset({HOSTNAME_TOPOLOGY_KEY, ZONE_TOPOLOGY_KEY})


def _selector_tuple(sel, what: str, allow_empty: bool):
    """parse_priority-style strictness for one label selector: a
    tuple/list of (str key, str value) pairs with non-empty keys.
    Returns the normalized tuple-of-tuples form (signatures and the
    affinity encoder both key on the exact tuple value)."""
    if not isinstance(sel, (tuple, list)):
        raise ValueError(f"bad {what} label_selector {sel!r}: must be a "
                         f"tuple of (key, value) pairs")
    out = []
    for item in sel:
        if (not isinstance(item, (tuple, list)) or len(item) != 2
                or not isinstance(item[0], str)
                or not isinstance(item[1], str) or not item[0]):
            raise ValueError(f"bad {what} label_selector entry {item!r}: "
                             f"must be a (non-empty str, str) pair")
        out.append((item[0], item[1]))
    if not out and not allow_empty:
        raise ValueError(f"bad {what}: label_selector must not be empty "
                         f"(an edge with no selector matches nothing)")
    return tuple(out)


def _topology_key(key, what: str) -> str:
    if key not in TOPOLOGY_KEYS:
        raise ValueError(f"bad {what} topology_key {key!r}: must be one "
                         f"of {sorted(TOPOLOGY_KEYS)}")
    return key


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = "topology.kubernetes.io/zone"
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: tuple[tuple[str, str], ...] = ()

    def __post_init__(self):
        # hard-reject at construction (the parse_priority convention):
        # a zero/negative skew or a bool would flow straight into the
        # int32 spread-bound tensor as a nonsense cap
        if isinstance(self.max_skew, bool) \
                or not isinstance(self.max_skew, int) or self.max_skew < 1:
            raise ValueError(f"bad topology_spread max_skew "
                             f"{self.max_skew!r}: must be an int >= 1")
        _topology_key(self.topology_key, "topology_spread")
        if self.when_unsatisfiable not in ("DoNotSchedule",
                                           "ScheduleAnyway"):
            raise ValueError(
                f"bad topology_spread when_unsatisfiable "
                f"{self.when_unsatisfiable!r}: must be DoNotSchedule or "
                f"ScheduleAnyway")
        # empty selector stays valid: it self-selects the pod's own
        # group (the pre-affinity spread semantics)
        object.__setattr__(
            self, "label_selector",
            _selector_tuple(self.label_selector, "topology_spread",
                            allow_empty=True))


@dataclass(frozen=True)
class PodAffinityTerm:
    """Simplified (anti-)affinity: match pods by label selector within a
    topology domain."""

    label_selector: tuple[tuple[str, str], ...] = ()
    topology_key: str = "kubernetes.io/hostname"
    anti: bool = False

    def __post_init__(self):
        object.__setattr__(
            self, "label_selector",
            _selector_tuple(self.label_selector, "affinity",
                            allow_empty=False))
        _topology_key(self.topology_key, "affinity")
        if not isinstance(self.anti, bool):
            raise ValueError(f"bad affinity anti {self.anti!r}: must be "
                             f"a bool")

    def matches(self, labels: tuple[tuple[str, str], ...]) -> bool:
        """True when every selector pair appears in ``labels``."""
        lab = dict(labels)
        return all(lab.get(k) == v for k, v in self.label_selector)


def pod_key(pod: "PodSpec") -> str:
    """Canonical pod identity: 'namespace/name'.  Every plan, nomination,
    and validator structure keys pods this way — bare names collide across
    namespaces.  Memoized on the (frozen) pod: the provisioner calls this
    for every pod on every solve window."""
    cached = getattr(pod, "_key_cache", None)
    if cached is None:
        cached = f"{pod.namespace}/{pod.name}"
        object.__setattr__(pod, "_key_cache", cached)
    return cached


_SIG_IDS: dict[tuple, int] = {}  # signature tuple -> interned id
_SIG_IDS_LOCK = threading.Lock()


@dataclass(frozen=True)
class PodSpec:
    """A pending pod as seen by the provisioner."""

    name: str
    namespace: str = "default"
    requests: ResourceRequests = field(default_factory=ResourceRequests)
    node_selector: tuple[tuple[str, str], ...] = ()
    required_requirements: tuple = ()      # tuple of Requirement (nodeAffinity required)
    # preferredDuringSchedulingIgnoredDuringExecution: (weight 1-100,
    # Requirement) terms — soft preferences lowered to cost penalties in
    # offering choice, never to hard masks (SURVEY §7.4)
    preferred_requirements: tuple = ()     # tuple of (int, Requirement)
    tolerations: tuple[Toleration, ...] = ()
    topology_spread: tuple[TopologySpreadConstraint, ...] = ()
    affinity: tuple[PodAffinityTerm, ...] = ()
    labels: tuple[tuple[str, str], ...] = ()
    # priorityClassName-style int (parse_priority semantics) — the
    # preemption plane's ordering key.  Validated at construction: every
    # PodSpec in the system carries an in-bounds int, so the solver's
    # group_prio tensor and the no-inversion checks never re-validate.
    priority: int = 0
    # gang membership (apis/podgroup.py): members of one PodGroup place
    # all-or-nothing, optionally on a contiguous torus slice.  None =
    # ordinary per-pod scheduling.  Strictly a PodGroup or None — a
    # malformed gang spec must fail at construction, not place per-pod.
    gang: PodGroup | None = None
    # usage distribution (karpenter_tpu/stochastic): mean/variance per
    # resource for chance-constrained packing under a NodePool
    # overcommit bound.  None = deterministic (mean=requests, var=0).
    # Strictly a UsageDistribution or None — its own __post_init__
    # hard-rejects malformed distributions.
    usage: UsageDistribution | None = None

    def __post_init__(self):
        object.__setattr__(self, "priority", parse_priority(self.priority))
        if self.gang is not None and not isinstance(self.gang, PodGroup):
            raise ValueError(f"bad gang {self.gang!r}: must be a PodGroup")
        if self.usage is not None \
                and not isinstance(self.usage, UsageDistribution):
            raise ValueError(f"bad usage {self.usage!r}: must be a "
                             f"UsageDistribution")
        for t in self.affinity:
            if not isinstance(t, PodAffinityTerm):
                raise ValueError(f"bad affinity term {t!r}: must be a "
                                 f"PodAffinityTerm")
            # required hostname affinity to the pod's OWN labels is a
            # self-edge: it is satisfied by the pod itself on any node
            # (kube counts the incoming pod), so it can never constrain
            # anything — reject it as a manifest bug rather than carry
            # a vacuous edge through the solver
            if (not t.anti and t.topology_key == HOSTNAME_TOPOLOGY_KEY
                    and self.labels and t.matches(self.labels)):
                raise ValueError(
                    f"bad affinity term {t!r}: required hostname "
                    f"affinity matching the pod's own labels is a "
                    f"vacuous self-edge")
        for c in self.topology_spread:
            if not isinstance(c, TopologySpreadConstraint):
                raise ValueError(f"bad topology_spread {c!r}: must be a "
                                 f"TopologySpreadConstraint")

    def scheduling_requirements(self) -> Requirements:
        reqs = Requirements.from_selector(dict(self.node_selector))
        for r in self.required_requirements:
            reqs.add(r)
        return reqs

    @property
    def labels_dict(self) -> dict[str, str]:
        return dict(self.labels)

    def constraint_signature(self) -> tuple:
        """Pods with identical signatures are interchangeable for placement —
        the host-side grouping key for the solver (solver/encode.py).
        Memoized: the provisioner re-encodes the same PodSpec instances every
        solve window, and signature construction dominates encode time at
        10k pods."""
        cached = getattr(self, "_sig_cache", None)
        if cached is not None:
            return cached
        sig = self._constraint_signature()
        object.__setattr__(self, "_sig_cache", sig)
        return sig

    def signature_key(self) -> str:
        """Stable string form of the constraint signature: the routing
        key of the shard router (``sharded/router.py``).  Memoized like
        the signature itself."""
        cached = getattr(self, "_sig_key", None)
        if cached is None:
            cached = repr(self.constraint_signature())
            object.__setattr__(self, "_sig_key", cached)
        return cached

    def signature_id(self) -> int:
        """Process-wide interned integer for the constraint signature —
        grouping 10k pods by int avoids re-hashing nested tuples on every
        encode.  Interning is locked: a racing setdefault(sig, len(map))
        could hand the same id to two different signatures."""
        cached = getattr(self, "_sig_id", None)
        if cached is None:
            sig = self.constraint_signature()
            with _SIG_IDS_LOCK:
                cached = _SIG_IDS.setdefault(sig, len(_SIG_IDS))
            object.__setattr__(self, "_sig_id", cached)
        return cached

    def _constraint_signature(self) -> tuple:
        # empty fast paths: the common pod carries no constraints, and
        # building 7 generator+sorted() pipelines per pod dominated cold
        # encode at 10k pods
        return (
            self.requests.as_tuple(),
            # priority splits groups: pods of different priorities are NOT
            # interchangeable once the preemption plane ranks them
            self.priority,
            # gang splits groups the same way: members place atomically,
            # so a member and a lookalike singleton must never share a row
            self.gang.signature() if self.gang is not None else None,
            # usage splits groups too: pods with different distributions
            # consume different chance-constrained capacity, so they are
            # NOT interchangeable under an overcommit bound
            self.usage.signature() if self.usage is not None else None,
            tuple(sorted(self.labels)) if self.labels else (),
            tuple(sorted(self.node_selector)) if self.node_selector else (),
            tuple(sorted(r.signature for r in self.required_requirements))
            if self.required_requirements else (),
            tuple(sorted((w, r.signature)
                         for w, r in self.preferred_requirements))
            if self.preferred_requirements else (),
            tuple(sorted((t.key, t.operator, t.value, t.effect)
                         for t in self.tolerations))
            if self.tolerations else (),
            tuple(sorted((c.max_skew, c.topology_key, c.when_unsatisfiable,
                          c.label_selector) for c in self.topology_spread))
            if self.topology_spread else (),
            tuple(sorted((a.label_selector, a.topology_key, a.anti)
                         for a in self.affinity)) if self.affinity else (),
        )


def fingerprint_token(pod: "PodSpec") -> tuple[str, int]:
    """THE canonical encode-memo token — (pod key, interned signature
    id) — memoized on the pod as ``_fpt``; the whole-encode memo of
    solver/encode.py keys on it."""
    tok = getattr(pod, "_fpt", None)
    if tok is None:
        tok = (pod_key(pod), pod.signature_id())
        object.__setattr__(pod, "_fpt", tok)
    return tok


def intern_signatures(pods) -> None:
    """Eagerly intern constraint signatures (and the encode fingerprint
    token) for a batch of pods.  The per-pod signature construction is
    the dominant cold-encode cost at 10k pods (~90 ms); production pods
    arrive through the watch stream, so the provisioner interns at
    ingestion time and the solve window's encode finds every token
    cached — the restart-window budget never pays it all at once."""
    for p in pods:
        fingerprint_token(p)


def make_pods(count: int, name_prefix: str = "pod", **kwargs) -> list[PodSpec]:
    """Convenience fan-out for tests/benchmarks."""
    return [PodSpec(name=f"{name_prefix}-{i}", **kwargs) for i in range(count)]
