"""Pod-to-pod (anti-)affinity and topology spread.

Port of ``karpenter_tpu/affinity``.  The encoder lowers each distinct
label selector of a window's terms to a selector class and each group's
hostname terms to int32 class bitmasks; the scan then checks every
pairwise constraint through per-node class presence:

- ``affinity/encode.py``   — selector classes, bitmasks, spread bounds,
  the zone co-pin prepass and the packed suffix leaf;
- ``affinity/kernel.py``   — the affinity-gated FFD scan;
- ``affinity/greedy.py``   — the bit-identical numpy parity oracle;
- ``affinity/enforce.py``  — the decode choke: every plan of a window
  with the plane passes host-side edge and bound enforcement;
- ``affinity/validate.py`` — the independent validator.

The constants below are shared by all of them.
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


def affinity_enabled(problem) -> bool:
    """Does this encoded problem carry the affinity plane?  True when
    the encoder attached an ``affinity.encode.AffinityIndex`` (at least
    one live inter-group edge or bounded spread class); an edge-free
    window is byte-identical to a build without this plane."""
    return getattr(problem, "aff", None) is not None
