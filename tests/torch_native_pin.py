"""The reference's native greedy route, pinned for both packages.

The reference builds its native library with ``make`` in place at first
load (``karpenter_tpu/native.py``); test workers building at once can
leave one of them holding a half-written library, and the failed load
is sticky for that process, so its greedy takes the python loop and
names its plans ``"greedy"`` where the port's says ``"greedy-native"``.
A test that compares ``plan.backend`` (or a digest that holds it) gives
both packages the same ``use_native``: ``"off"`` when the reference's
library did not load in this process, else the default.
"""

from __future__ import annotations

from karpenter_tpu import native as j_native


def native_pin() -> str:
    """``use_native`` for both packages' greedy solvers in this process."""
    return "off" if j_native.load() is None else "auto"
