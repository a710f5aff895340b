"""Crash-recovery plane: write-ahead intent journal + restart reconciler.

The operator process is the last single point of silent state loss the
chaos matrix could not reach: a crash between ``rpc.create_vni`` and
``rpc.create_instance`` leaks resources, a crash after a create but
before nomination strands a node for the orphan reaper, and a restart
forgets in-flight evictions, gang admissions, and repack migrations
entirely.  This package closes that gap (docs/design/recovery.md):

- :mod:`~karpenter_tpu_torch.recovery.journal` — an append-only JSONL
  write-ahead journal: every mutating actuation records a durable
  *intent* before its first RPC and a completion record after; cloud
  creates carry a deterministic idempotency key derived from the intent
  id so a replayed create is a lookup, not a duplicate;
- :mod:`~karpenter_tpu_torch.recovery.reconciler` — the restart path: replay
  open intents against cloud + cluster ground truth, fence or finish
  each one, rebuild nominations / gang park state / preemption
  ``preempted_keys`` from the journal's state records, then hand off to
  the existing AOT prewarm + resident rebuild;
- :mod:`~karpenter_tpu_torch.recovery.crashpoints` — the deterministic
  crash-injection hook the crashpoint chaos dimension
  (``chaos/crash.py``) drives.

(Copy of ``karpenter_tpu/recovery/__init__.py``.)
"""

from __future__ import annotations

from karpenter_tpu_torch.recovery.crashpoints import (  # noqa: F401
    CrashInjector, SimulatedCrash, hit, installed,
)
from karpenter_tpu_torch.recovery.journal import (  # noqa: F401
    NULL_JOURNAL, Intent, IntentJournal, NullJournal, read_journal,
)
from karpenter_tpu_torch.recovery.reconciler import (  # noqa: F401
    Reconciler, RecoveryReport,
)
