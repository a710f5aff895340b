"""Chance-constrained stochastic packing: the constants and z(eps).

Port of ``karpenter_tpu/stochastic/__init__.py``.  Pod usage is a
distribution: each pod carries a per-resource (mean, variance) pair and
a pool an overcommit bound epsilon (``NodePool.overcommit``).  A node is
chance-feasible when, per resource dimension,

    sum(mean) + z(eps) * sqrt(sum(variance)) <= capacity

which the device scan (``stochastic/kernel.py``) checks in the
square-compare form ``zsq * sum(var) <= (cap - sum(mean))^2``.

- ``stochastic/encode.py``   — usage rows and the packed mean/var leaf;
- ``stochastic/kernel.py``   — the chance-constrained FFD scan;
- ``stochastic/greedy.py``   — the bit-identical numpy parity oracle;
- ``stochastic/validate.py`` — the independent chance-constraint check.

Every numeric constant the scan and its checks share lives here.
"""

from __future__ import annotations

import math

import numpy as np

# Binary-search bounds of the quantile check: the fit count is clamped to
# CHANCE_FIT_MAX and resolved in CHANCE_ITERS fixed iterations (12 =
# ceil(log2(2047 + 2)) resolves the range exactly).
CHANCE_FIT_MAX = 2047
CHANCE_ITERS = 12

# epsilon floor: z(eps) explodes as eps -> 0
EPS_MIN = 1e-6


def z_value(eps: float) -> float:
    """One-sided standard-normal quantile z with P(X > z) = eps: the
    Hastings tail approximation tightened by one Newton step against the
    exact normal tail (float64, stdlib only)."""
    eps = min(max(float(eps), EPS_MIN), 0.5)
    q = 1.0 - eps
    if q == 0.5:
        return 0.0
    t = math.sqrt(-2.0 * math.log(eps))
    z = t - ((2.515517 + 0.802853 * t + 0.010328 * t * t)
             / (1.0 + 1.432788 * t + 0.189269 * t * t
                + 0.001308 * t * t * t))
    pdf = math.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    cdf_tail = 0.5 * math.erfc(z / math.sqrt(2.0))
    if pdf > 0:
        z -= (eps - cdf_tail) / pdf
    return z


def z_bp_for(eps: float) -> int:
    """z(eps) quantized to basis points (z * 10000, int)."""
    return int(round(z_value(eps) * 10000.0))


def zsq_value(z_bp: int) -> float:
    """The squared z constant of the quantile check, rounded through
    float32 on the host exactly as the reference does, so every side
    compares against the same float32 value."""
    zf = np.float32(np.float32(z_bp) * np.float32(1e-4))
    return float(np.float32(zf * zf))


def stochastic_enabled(problem) -> bool:
    """True when the encoder attached mean/variance tensors (the pool
    overcommits)."""
    return getattr(problem, "group_var", None) is not None
