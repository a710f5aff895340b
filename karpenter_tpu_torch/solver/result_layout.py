"""The ONE versioned layout of the packed result buffer's suffix.

Every packed solve result shares the wire shape

    [0, N)            node_off          (-1 = unused slot)
    [N, N+G)          unplaced per group
    [N+G]             cost              (float32 bit pattern)
    tail              COO idx/cnt or dense assign (result_tail_len)
    [G]               explain reason words   (karpenter_tpu_torch/explain)
    [TELEMETRY_LEN]   telemetry block: 1 magic/version word +
                      TELEMETRY_SLOT_COUNT per-window quality slots
                      (karpenter_tpu_torch/obs/telemetry_words)

Port of ``karpenter_tpu/solver/result_layout.py``: every producer
(``solver/packed.pack_result_telemetry``) and consumer (plan decode,
tests) of the port references THIS module for the suffix offsets.

Versioning: the telemetry block LEADS with ``TELEMETRY_MAGIC`` (a
sentinel carrying ``SUFFIX_VERSION`` in its low byte).  A buffer from
an older layout — wrong length or wrong magic — raises
``SuffixLayoutError`` loudly instead of mis-decoding garbage counters
into dashboards.  ``unpack_reason_words`` keeps its historical
tolerance (None for a bare ``_pack_result`` buffer without any suffix,
the direct-kernel-caller layout).

Host-only module: numpy + stdlib.
"""

from __future__ import annotations

import numpy as np

# bump when the suffix layout changes shape or meaning; the magic word
# carries it so a stale buffer (old producer, new consumer or vice
# versa) is REJECTED, never silently mis-decoded
SUFFIX_VERSION = 1

# int32 sentinel leading the telemetry block: 0x7E1E tag | version.
# Chosen to be an implausible value for any real slot word (negative
# counts never occur; basis-point slots cap at 10000).
TELEMETRY_MAGIC = np.int32((0x7E1E << 16) | SUFFIX_VERSION)

# Slot indices within the telemetry block (AFTER the magic word).
# MUST enumerate identically to obs/telemetry_words.TELEMETRY_SLOTS.
# Device-sourced slots are masked reductions inside
# the solve dispatch; host-sourced slots ride the wire as zero and are
# filled at decode/record time (escalation counts and rebalance skew
# are host control-flow facts the kernel cannot know).
SLOT_FILL_CPU_BP = 0
SLOT_FILL_MEM_BP = 1
SLOT_FILL_ACCEL_BP = 2
SLOT_FILL_PODS_BP = 3
SLOT_SLACK_MIN_BP = 4
SLOT_SLACK_MEAN_BP = 5
SLOT_NODES_OPEN = 6
SLOT_GROUPS_PLACED = 7
SLOT_GROUPS_UNPLACED = 8
SLOT_PODS_UNPLACED = 9
SLOT_BINDING_GROUPS = 10
SLOT_ESCALATIONS = 11
SLOT_COO_GROWTHS = 12
SLOT_DELTA_WORDS = 13
SLOT_REBALANCE_SKEW = 14

TELEMETRY_SLOT_COUNT = 15
# magic word + slots
TELEMETRY_LEN = 1 + TELEMETRY_SLOT_COUNT

# basis-point denominator shared by the device reduction, the numpy
# oracle, and every host consumer turning slots into fractions
BP_SCALE = 10000


class SuffixLayoutError(ValueError):
    """A packed result buffer does not carry the telemetry suffix this
    build expects — wrong length or wrong magic/version word.  Raised
    LOUDLY instead of mis-decoding an old-layout buffer."""


def result_tail_len(G: int, N: int, K: int, dense16: bool = False,
                    coo16: bool = False) -> int:
    """Words in the assignment tail of a packed result buffer — the ONE
    offset arithmetic every suffix reader shares."""
    if K > 0:
        return K if coo16 else 2 * K
    if dense16:
        return (G * N) // 2
    return G * N


def reason_words_offset(G: int, N: int, K: int, dense16: bool = False,
                        coo16: bool = False) -> int:
    """Offset of the [G] explain reason words in a packed result."""
    return N + G + 1 + result_tail_len(G, N, K, dense16, coo16)


def telemetry_offset(G: int, N: int, K: int, dense16: bool = False,
                     coo16: bool = False) -> int:
    """Offset of the telemetry block (its magic word) in a packed
    result."""
    return reason_words_offset(G, N, K, dense16, coo16) + G


def result_len(G: int, N: int, K: int, dense16: bool = False,
               coo16: bool = False) -> int:
    """Total words of a v1 packed result buffer including both
    suffixes — the length every finisher and oracle must produce."""
    return telemetry_offset(G, N, K, dense16, coo16) + TELEMETRY_LEN


def unpack_reason_words(out: np.ndarray, G: int, N: int, K: int,
                        dense16: bool = False,
                        coo16: bool = False) -> np.ndarray | None:
    """The appended [G] explain reason words of a packed result buffer
    (karpenter_tpu_torch/explain), or None for a legacy buffer without them
    (the bare ``_pack_result`` layout direct kernel callers produce)."""
    off = reason_words_offset(G, N, K, dense16, coo16)
    if out.shape[0] < off + G:
        return None
    return out[off:off + G]


def unpack_telemetry_words(out: np.ndarray, G: int, N: int, K: int,
                           dense16: bool = False,
                           coo16: bool = False) -> np.ndarray:
    """The [TELEMETRY_SLOT_COUNT] telemetry slots of a packed result.

    STRICT by contract (the version-bump compatibility test): a buffer
    that is too short (pre-telemetry layout) or whose block does not
    lead with this build's ``TELEMETRY_MAGIC`` raises
    :class:`SuffixLayoutError` — an old-layout buffer must fail loudly,
    never be mis-decoded into plausible-looking counters."""
    off = telemetry_offset(G, N, K, dense16, coo16)
    if out.shape[0] != off + TELEMETRY_LEN:
        raise SuffixLayoutError(
            f"packed result has {out.shape[0]} words, expected "
            f"{off + TELEMETRY_LEN} for suffix v{SUFFIX_VERSION} "
            f"(G={G}, N={N}, K={K}, dense16={dense16}, coo16={coo16}) — "
            f"old-layout buffer or shape mismatch")
    magic = int(out[off])
    if magic != int(TELEMETRY_MAGIC):
        raise SuffixLayoutError(
            f"telemetry magic word {magic:#x} != expected "
            f"{int(TELEMETRY_MAGIC):#x} (suffix v{SUFFIX_VERSION}) — "
            f"buffer produced by a different suffix layout version")
    return out[off + 1:off + TELEMETRY_LEN]
