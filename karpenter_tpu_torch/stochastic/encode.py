"""Stochastic lowering: pod usage distributions -> dense group tensors.

Port of the encode-time half of ``karpenter_tpu/stochastic/encode.py``:
``solver/encode.py`` calls :func:`usage_rows` per signature group when
the pool overcommits, so the mean/var rows ride the same grouping, FFD
sort and spread split as the deterministic columns.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.apis.pod import NUM_RESOURCES, PodSpec


def usage_rows(pod: PodSpec) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(mean row, var row) for one representative pod.

    Defaults make the plane a strict superset: no distribution ->
    (requests, 0).  The pods axis is floored at 1 exactly as the
    deterministic ``req_row`` is — every pod occupies a slot, so the
    chance-fit binary search always has a finite per-node bound."""
    req = pod.requests.as_tuple()
    if pod.usage is None:
        mean = (req[0], req[1], req[2], max(req[3], 1))
        return mean, (0, 0, 0, 0)
    m = pod.usage.mean.as_tuple()
    return (m[0], m[1], m[2], max(m[3], 1)), tuple(pod.usage.var)


def stack_usage(g_mean: list, g_var: list) -> tuple[np.ndarray, np.ndarray]:
    """Group rows -> the int32 [G, R] tensors the kernel consumes."""
    G = len(g_mean)
    mean = np.asarray(g_mean, dtype=np.int32).reshape(G, NUM_RESOURCES)
    var = np.asarray(g_var, dtype=np.int32).reshape(G, NUM_RESOURCES)
    return mean, var
