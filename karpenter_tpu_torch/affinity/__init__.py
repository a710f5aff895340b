"""Pod-to-pod (anti-)affinity and topology spread: the encode-time half.

The constants the encoder's class lowering shares with the reference's
affinity kernel (``karpenter_tpu/affinity``).  Windows that arm the
plane are not served by this package yet.
"""

from __future__ import annotations

# Selector-class budget of the device lane: class masks are int32
# bitmasks, and bit 31 is the sign bit while bit 30 guards the ``~mask``
# complement arithmetic.
MAX_SELECTOR_CLASSES = 30

# Padded class-axis width of the device lane's per-node count grid.
C_PAD = 32

# "Unbounded" sentinel for spread-bound rows.
AFF_BIG = 1 << 20
