"""The serving loop: a persistent device-resident solve service.

Port of ``karpenter_tpu/serving``.  The packed problem state lives on the
device (the resident store's mirror discipline) and each submitted window
uploads only its padded word delta; one kick per window applies the
delta and solves (``serving/kernels.serve_window``,
the ``solve_resident`` body), and the result waits in an output ring
whose device-to-host copy runs while later windows are kicked.

- :mod:`karpenter_tpu_torch.serving.ring` — the delta staging and the
  output ring.
- :mod:`karpenter_tpu_torch.serving.kernels` — ``apply_ring`` and
  ``serve_window``.
- :mod:`karpenter_tpu_torch.serving.oracle` — the numpy twins and
  ``RingOracle``, the host replay of every admitted slot.
- :mod:`karpenter_tpu_torch.serving.service` — ``ServingLoop``: the
  eligibility gate, the resident ladder (rebuild / delta / hit), and the
  routing of ineligible and backpressured windows to the classic
  dispatch.  A failed kick or fetch invalidates the ring and raises.
- :mod:`karpenter_tpu_torch.serving.validate` — ring-fed against classic
  solves, raw words and decoded plans.

Opt-in through ``SolverOptions(serving="on")`` or, with ``"auto"``, the
environment variable ``KARPENTER_ENABLE_SERVING``.
"""

from __future__ import annotations

import os

# Ring capacity (slots): bounds the windows in flight and not fetched.
RING_SLOTS = 8


def serving_enabled(options=None, env=None) -> bool:
    """The one gate: ``SolverOptions.serving`` "on"/"off" wins; "auto"
    defers to ``KARPENTER_ENABLE_SERVING``."""
    mode = getattr(options, "serving", "auto") if options is not None \
        else "auto"
    if mode == "on":
        return True
    if mode == "off":
        return False
    raw = (os.environ if env is None else env).get(
        "KARPENTER_ENABLE_SERVING", "")
    return raw.lower() in ("1", "true", "yes", "on")


__all__ = ["RING_SLOTS", "serving_enabled"]
