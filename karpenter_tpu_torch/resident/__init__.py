"""Device-resident problem state: delta-encoded incremental solves.

Port of ``karpenter_tpu/resident``.  Consecutive provisioning windows
differ by a few pod arrivals and departures, which change a handful of
words of the packed problem buffer.  The resident store keeps that
buffer on the device and moves only the words that changed:

- :mod:`karpenter_tpu_torch.resident.delta` — the delta encoder: the
  changed words of a window against the host mirror of the device
  buffer, padded to a small ladder of sizes (``DELTA_BUCKETS``).
- :mod:`karpenter_tpu_torch.resident.kernels` — ``update_resident`` (the
  word scatter, in place into the persistent device tensor) and
  ``solve_resident`` (the scatter, then the packed solve of the main path
  on the updated buffer, on one stream).
- :mod:`karpenter_tpu_torch.resident.store` — ``ResidentStore`` (what
  ``TorchSolver`` dispatches through) and ``ResidentBuffer`` (one
  resident buffer + mirror; the fleet keeps its stacked input with it).
  A catalog update, a shape change or an oversized delta rebuilds the
  buffer from the host; a failed resident program invalidates the store
  and raises (it never falls back to the classic path).

Opt-in through ``SolverOptions(resident="on")`` or, with ``"auto"``,
the environment variable ``KARPENTER_ENABLE_RESIDENT``.
"""

from __future__ import annotations

import os


def resident_enabled(options=None, env=None) -> bool:
    """The one gate: ``SolverOptions.resident`` "on"/"off" wins; "auto"
    defers to ``KARPENTER_ENABLE_RESIDENT``."""
    mode = getattr(options, "resident", "auto") if options is not None \
        else "auto"
    if mode == "on":
        return True
    if mode == "off":
        return False
    raw = (os.environ if env is None else env).get(
        "KARPENTER_ENABLE_RESIDENT", "")
    return raw.lower() in ("1", "true", "yes", "on")


__all__ = ["resident_enabled"]
