"""Stochastic lowering: pod usage distributions -> dense group tensors.

Port of ``karpenter_tpu/stochastic/encode.py``: ``solver/encode.py``
calls :func:`usage_rows` per signature group when the pool overcommits,
so the mean/var rows ride the same grouping, FFD sort and spread split
as the deterministic columns.  The packed problem buffer of a dispatch
is unchanged; the rows travel as one extra int32 leaf
(:func:`pack_stochastic`):

    [0,   G*4)   group mean  [G, R]  (int32, request units)
    [G*4, G*8)   group var   [G, R]  (int32, request units squared)
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


def pack_stochastic(group_mean: np.ndarray, group_var: np.ndarray,
                    G_pad: int) -> np.ndarray:
    """The int32 suffix leaf of a stochastic dispatch: mean rows [G, R]
    then var rows [G, R], zero-padded to the group bucket (padding groups
    carry mean 0 / var 0 and place nothing)."""
    G = group_mean.shape[0]
    buf = np.zeros(G_pad * 2 * NUM_RESOURCES, dtype=np.int32)
    buf[:G * NUM_RESOURCES] = group_mean.reshape(-1)
    half = G_pad * NUM_RESOURCES
    buf[half:half + G * NUM_RESOURCES] = group_var.reshape(-1)
    return buf


def unpack_stochastic(buf: np.ndarray, G_pad: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of :func:`pack_stochastic`."""
    half = G_pad * NUM_RESOURCES
    mean = np.asarray(buf[:half]).reshape(G_pad, NUM_RESOURCES)
    var = np.asarray(buf[half:2 * half]).reshape(G_pad, NUM_RESOURCES)
    return mean, var
