"""Independent chance-constraint validation + measured violation rate.

Port of ``karpenter_tpu/stochastic/validate.py``.  Two checks that share
no code path with the solver:

- :func:`node_chance_violations` re-derives, from raw pods + catalog +
  epsilon (NEVER from solver tensors), whether every planned node
  satisfies ``sum(mean) + z(eps) * sqrt(sum(var)) <= allocatable`` per
  dimension.  ``solver/validate.py`` routes its per-node capacity check
  here when the pool overcommits: float64 with a small relative slack,
  deliberately NOT the kernel's float32 arithmetic (an independent
  check that mirrored the kernel's rounding would inherit its bugs).

- :func:`measured_violation_rate` draws actual usage from each pod's
  distribution (seeded Gaussian, truncated at zero) and measures the
  node-overload frequency: the EMPIRICAL rate, not the model's promise,
  must stay at or under epsilon (plus finite-sample slack,
  :func:`violation_bound`).
"""

from __future__ import annotations

import math

import numpy as np

from karpenter_tpu_torch.apis.pod import NUM_RESOURCES, PodSpec
from karpenter_tpu_torch.stochastic import z_value

# float comparison slack for the validator: the kernel certifies the
# constraint in float32 square-compare form, which can admit a node a
# hair past the exact real-arithmetic bound — the independent check
# must not flag that rounding as a capacity violation
_REL_SLACK = 1e-5
_ABS_SLACK = 1e-3


def pod_mean_var(pod: PodSpec) -> tuple[np.ndarray, np.ndarray]:
    """(mean [R], var [R]) float64 — requests/0 when no distribution."""
    if pod.usage is None:
        return (np.asarray(pod.requests.as_tuple(), dtype=np.float64),
                np.zeros(NUM_RESOURCES, dtype=np.float64))
    return (np.asarray(pod.usage.mean.as_tuple(), dtype=np.float64),
            np.asarray(pod.usage.var, dtype=np.float64))


def node_chance_violations(node_pods: list[PodSpec], alloc,
                           eps: float, label: str = "node") -> list[str]:
    """Violation strings for ONE node's chance constraint."""
    z = z_value(eps)
    mean = np.zeros(NUM_RESOURCES, dtype=np.float64)
    var = np.zeros(NUM_RESOURCES, dtype=np.float64)
    for pod in node_pods:
        m, v = pod_mean_var(pod)
        mean += m
        var += v
    out: list[str] = []
    for r in range(NUM_RESOURCES):
        demand = mean[r] + z * math.sqrt(var[r])
        bound = float(alloc[r]) * (1.0 + _REL_SLACK) + _ABS_SLACK
        if demand > bound:
            out.append(
                f"{label}: chance constraint violated on axis {r}: "
                f"mean {mean[r]:.1f} + z({eps:g})*sqrt(var) "
                f"= {demand:.1f} > allocatable {float(alloc[r]):.1f}")
    return out


def measured_violation_rate(nodes: list[tuple[list[PodSpec], np.ndarray]],
                            trials: int = 256,
                            seed: int = 0) -> tuple[float, int]:
    """Empirical overload frequency over seeded usage draws.

    ``nodes`` is [(pods on node, allocatable [R])]; each trial draws
    every pod's usage from N(mean, var) truncated at 0.  One SAMPLE is
    a (node, trial, dimension) triple over dimensions that carry any
    variance — the unit the per-dimension chance constraint actually
    bounds at epsilon (counting "any dimension over" would union-bound
    to R*epsilon and flag correct packers).  Returns (rate, samples).
    Deterministic per seed — the chaos determinism contract."""
    rng = np.random.RandomState(seed)
    samples = 0
    overloads = 0
    for pods, alloc in nodes:
        if not pods:
            continue
        means = np.stack([pod_mean_var(p)[0] for p in pods])   # [P, R]
        stds = np.sqrt(np.stack([pod_mean_var(p)[1] for p in pods]))
        active = np.nonzero(stds.sum(axis=0) > 0)[0]
        if active.size == 0:
            continue
        draws = rng.normal(means[None, :, :], stds[None, :, :],
                           size=(trials,) + means.shape)
        draws = np.maximum(draws, 0.0)
        totals = draws.sum(axis=1)                             # [T, R]
        alloc_f = np.asarray(alloc, dtype=np.float64)
        over = totals[:, active] > alloc_f[None, active]       # [T, A]
        overloads += int(over.sum())
        samples += trials * int(active.size)
    return (overloads / samples if samples else 0.0), samples


def violation_bound(eps: float, samples: int) -> float:
    """The pass bar for a finite-sample measured rate: eps plus three
    binomial standard errors (a correct packer still shows sampling
    noise; a broken one blows far past this)."""
    if samples <= 0:
        return eps
    return eps + 3.0 * math.sqrt(max(eps * (1.0 - eps), 1e-9) / samples) \
        + 1e-9
