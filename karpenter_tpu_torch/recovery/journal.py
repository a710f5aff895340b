"""Write-ahead intent journal: durable record of every mutating actuation.

Format (append-only JSONL; docs/design/recovery.md "journal format"):

- ``{"rec":"intent","id","kind","t","owner","payload"}`` — written and
  **fsynced before the first RPC** of the actuation it describes (the
  write-ahead guarantee: the cloud can never hold a resource the journal
  has no intent for);
- ``{"rec":"note","id","stage","t","data"}`` — per-stage progress
  (VNI id, volume ids, instance id) written *after* each RPC returns, so
  replay knows exactly how far the sequence got;
- ``{"rec":"done","id","t","outcome","detail"}`` — completion.  A crash
  between the intent and its ``done`` leaves the intent *open*; the
  restart reconciler fences or finishes it;
- ``{"rec":"state","key","t","value"}`` — keyed control-plane state
  (nominations, ``preempted_keys``, gang admissions) with newest-wins
  semantics; ``value: null`` is a tombstone.  Restart rebuilds volatile
  controller state from the surviving map.

Timestamps come from ``time.time()`` **at call time**, so the chaos
VirtualClock stamps journal records in scenario time (deterministic
replay).  Idempotency keys are derived from the intent id
(``<intent-id>/<stage>``): a replayed create with the same key is a
lookup on the cloud side, never a duplicate.

Durability is fsync-batched: intent records always fsync (write-ahead);
notes/dones/state fsync every ``fsync_interval`` records or at flush.
The file is bounded: once more than ``max_records`` have accumulated,
compaction rewrites it keeping only open intents and the newest state
record per key (atomic ``os.replace``).  The next compaction waits for
``max(max_records, 2 * live)`` records, where ``live`` is what the last
one kept: the file stays within twice its live set, and compaction is
amortized over the appends.

(Copy of ``karpenter_tpu/recovery/journal.py``, but for that threshold:
the reference compacts on every append once the live set alone exceeds
``max_records``, so an operator nominating 10,000 pods rewrote the
whole file about 6,000 times.)
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from dataclasses import dataclass, field

from karpenter_tpu_torch.recovery import crashpoints
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("recovery.journal")

# intent kinds the actuation plane records (docs/design/recovery.md)
KIND_NODE_CREATE = "node_create"
KIND_CLAIM_DELETE = "claim_delete"
KIND_EVICTION = "eviction"
KIND_GANG_PLACEMENT = "gang_placement"
KIND_REPACK_MIGRATION = "repack_migration"
KIND_ORPHAN_DELETE = "orphan_delete"


@dataclass
class Intent:
    """One open intent handle (yielded by :meth:`IntentJournal.intent`)."""

    id: str
    kind: str
    payload: dict
    journal: "IntentJournal | None" = None
    notes: dict[str, dict] = field(default_factory=dict)
    outcome: str = ""          # set at completion

    def idem_key(self, stage: str) -> str:
        """Deterministic idempotency key for one staged RPC.  Empty when
        journaling is off (NullJournal) or the journal's ``idempotency``
        switch is off (the deliberately-broken chaos fixture) — the
        cloud treats "" as no-key."""
        if not self.id or (self.journal is not None
                           and not getattr(self.journal, "idempotency",
                                           True)):
            return ""
        return f"{self.id}/{stage}"

    def note(self, stage: str, **data) -> None:
        self.notes[stage] = data
        if self.journal is not None:
            self.journal._append({"rec": "note", "id": self.id,
                                  "stage": stage, "t": time.time(),
                                  "data": data})


class _NullIntent(Intent):
    def idem_key(self, stage: str) -> str:
        return ""

    def note(self, stage: str, **data) -> None:
        pass


class _IntentCtx:
    """Context manager around one intent: write-ahead on enter, done on
    exit.  ``ok`` exceptions complete as success (the actuator's
    delete path *raises* NodeClaimNotFoundError on success — the
    finalizer-release contract).  :class:`SimulatedCrash` (and any other
    BaseException that is not an Exception) writes NOTHING — a real
    crash does not get to record its own completion."""

    def __init__(self, journal: "IntentJournal", kind: str, payload: dict,
                 ok: tuple[type[BaseException], ...] = ()):
        self.journal = journal
        self.kind = kind
        self.payload = payload
        self.ok = ok
        self.intent: Intent | None = None

    def __enter__(self) -> Intent:
        self.intent = self.journal.open(self.kind, self.payload)
        return self.intent

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is None:
            self.journal.complete(self.intent, "ok")
        elif isinstance(exc, self.ok):
            self.journal.complete(self.intent, "ok",
                                  detail=type(exc).__name__)
        elif isinstance(exc, Exception):
            # the actuation failed CLEANLY (its own compensation ran);
            # the intent closes so replay does not re-drive it
            self.journal.complete(self.intent, "failed",
                                  detail=str(exc)[:200])
        # a BaseException (SimulatedCrash, KeyboardInterrupt) writes no
        # completion: the intent stays open for the reconciler
        return False


class NullJournal:
    """Do-nothing journal with the full surface — the default wiring, so
    actuation code reads unconditionally (null-object pattern)."""

    path = ""

    def intent(self, kind: str, ok: tuple = (), **payload) -> "_NullCtx":
        return _NullCtx()

    def state(self, key: str, value) -> None:
        pass

    def open(self, kind: str, payload: dict) -> Intent:
        return _NullIntent(id="", kind=kind, payload=payload)

    def complete(self, intent: Intent, outcome: str, detail: str = "") -> None:
        pass

    def complete_id(self, intent_id: str, outcome: str,
                    detail: str = "") -> None:
        pass

    def open_intents(self) -> list[Intent]:
        return []

    def state_map(self) -> dict:
        return {}

    def flush(self) -> None:
        pass

    def compact(self) -> None:
        pass

    def close(self) -> None:
        pass

    def stats(self) -> dict:
        return {"enabled": False}


class _NullCtx:
    def __enter__(self) -> Intent:
        return _NullIntent(id="", kind="", payload={})

    def __exit__(self, *exc) -> bool:
        return False


NULL_JOURNAL = NullJournal()


class IntentJournal(NullJournal):
    """The real journal (see module docstring)."""

    def __init__(self, path: str, *, owner: str = "",
                 fsync_interval: int = 16, max_records: int = 4096,
                 max_state_keys: int = 65536, fsync: bool = True,
                 idempotency: bool = True):
        self.path = str(path)
        self.owner = owner or "operator"
        # False ONLY in the deliberately-broken chaos fixture: intents
        # mint no idempotency keys, so a replayed create duplicates —
        # provably failing the no-double-create invariant
        self.idempotency = idempotency
        self.fsync_interval = max(1, int(fsync_interval))
        self.max_records = max(64, int(max_records))
        self.max_state_keys = max_state_keys
        self._fsync_enabled = fsync
        self._lock = threading.RLock()
        self._fh: io.TextIOBase | None = None
        self._unsynced = 0
        self._records = 0          # records in the file (approx, see load)
        # the record count that triggers the next compaction
        self._compact_at = self.max_records
        self._compactions = 0
        # in-memory mirrors of what is on disk (kept current so open
        # intents / state reads never re-parse the file on the hot path)
        self._open: dict[str, Intent] = {}
        self._state: dict[str, object] = {}
        self._seq = 0
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        self._load()

    # -- write path --------------------------------------------------------

    def intent(self, kind: str, ok: tuple = (), **payload) -> _IntentCtx:
        """Open a write-ahead intent for the ``with`` block; the intent
        record is durable before the block body (the first RPC) runs."""
        return _IntentCtx(self, kind, payload, ok=tuple(ok))

    def open(self, kind: str, payload: dict) -> Intent:
        with self._lock:
            self._seq += 1
            intent = Intent(id=f"{self.owner}-{self._seq:06d}", kind=kind,
                            payload=dict(payload), journal=self)
            self._open[intent.id] = intent
            self._append({"rec": "intent", "id": intent.id, "kind": kind,
                          "t": time.time(), "owner": self.owner,
                          "payload": intent.payload}, durable=True)
            metrics.JOURNAL_OPEN_INTENTS.set(len(self._open))
        return intent

    def complete(self, intent: Intent, outcome: str, detail: str = "") -> None:
        if intent is None or not intent.id:
            return
        self.complete_id(intent.id, outcome, detail)
        intent.outcome = outcome

    def complete_id(self, intent_id: str, outcome: str,
                    detail: str = "") -> None:
        with self._lock:
            rec = {"rec": "done", "id": intent_id, "t": time.time(),
                   "outcome": outcome}
            if detail:
                rec["detail"] = detail
            self._append(rec, durable=True)
            self._open.pop(intent_id, None)
            metrics.JOURNAL_OPEN_INTENTS.set(len(self._open))

    def state(self, key: str, value) -> None:
        """Keyed newest-wins state record; ``None`` tombstones the key."""
        with self._lock:
            if value is None:
                if key not in self._state:
                    return          # tombstoning the absent: no record
                self._state.pop(key, None)
            else:
                self._state[key] = value
                while len(self._state) > self.max_state_keys:
                    self._state.pop(next(iter(self._state)))
            self._append({"rec": "state", "key": key, "t": time.time(),
                          "value": value})

    def _append(self, rec: dict, durable: bool = False) -> None:
        # the mid-journal-append crashpoint: the process dies with the
        # record composed but never written — exactly a torn write
        crashpoints.hit("journal.append")
        with self._lock:
            fh = self._handle_locked()
            fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
            fh.flush()
            self._records += 1
            self._unsynced += 1
            metrics.JOURNAL_RECORDS.labels(rec["rec"]).inc()
            if durable or self._unsynced >= self.fsync_interval:
                self._fsync_locked()
            if self._records > self._compact_at:
                self._compact_locked()

    def _fsync_locked(self) -> None:
        if self._fsync_enabled and self._fh is not None:
            os.fsync(self._fh.fileno())
        self._unsynced = 0

    def _handle_locked(self) -> io.TextIOBase:
        if self._fh is None:
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fsync_locked()
            metrics.JOURNAL_BYTES.set(self._size())

    def close(self) -> None:
        with self._lock:
            self.flush()
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- read path ---------------------------------------------------------

    def open_intents(self) -> list[Intent]:
        with self._lock:
            return list(self._open.values())

    def state_map(self) -> dict:
        with self._lock:
            return dict(self._state)

    def _load(self) -> None:
        """Reopen after a (real or simulated) crash: rebuild the open-set
        and state map from disk, tolerating a torn final line."""
        intents, state, records, max_seq = read_journal(self.path)
        with self._lock:
            self._open = {i.id: i for i in intents if not i.outcome}
            for i in self._open.values():
                i.journal = self
            self._state = state
            self._records = records
            self._seq = max_seq
            metrics.JOURNAL_OPEN_INTENTS.set(len(self._open))

    # -- compaction --------------------------------------------------------

    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Rewrite keeping only open intents (with their notes) and the
        newest state record per key.  Crash-safe: written to a temp file
        and atomically swapped in."""
        tmp = self.path + ".compact"
        now = time.time()
        n = 0
        with open(tmp, "w", encoding="utf-8") as out:
            # the seq high-water mark MUST survive compaction: dropped
            # (completed) intents are the only other record of it, and a
            # reused intent id would reuse its idempotency keys — a new
            # create would silently return a stale cloud resource
            out.write(json.dumps({"rec": "seq", "n": self._seq, "t": now},
                                 separators=(",", ":")) + "\n")
            n += 1
            for intent in self._open.values():
                out.write(json.dumps(
                    {"rec": "intent", "id": intent.id, "kind": intent.kind,
                     "t": now, "owner": self.owner,
                     "payload": intent.payload},
                    separators=(",", ":")) + "\n")
                n += 1
                for stage, data in intent.notes.items():
                    out.write(json.dumps(
                        {"rec": "note", "id": intent.id, "stage": stage,
                         "t": now, "data": data},
                        separators=(",", ":")) + "\n")
                    n += 1
            for key, value in self._state.items():
                out.write(json.dumps(
                    {"rec": "state", "key": key, "t": now, "value": value},
                    separators=(",", ":")) + "\n")
                n += 1
            out.flush()
            if self._fsync_enabled:
                os.fsync(out.fileno())
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        os.replace(tmp, self.path)
        self._records = n
        self._compact_at = max(self.max_records, 2 * n)
        self._unsynced = 0
        self._compactions += 1
        metrics.JOURNAL_COMPACTIONS.inc()
        metrics.JOURNAL_BYTES.set(self._size())
        log.info("journal compacted", path=self.path, records=n,
                 open_intents=len(self._open))

    # -- introspection -----------------------------------------------------

    def _size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "path": self.path,
                "owner": self.owner,
                "records": self._records,
                "open_intents": len(self._open),
                "state_keys": len(self._state),
                "bytes": self._size(),
                "compactions": self._compactions,
            }


def read_journal(path: str) -> tuple[list[Intent], dict, int, int]:
    """Parse a journal file -> (all intents with outcome filled where
    completed, state map, record count, max seq seen).  A torn final
    line (crash mid-write) is skipped; torn middle lines are skipped
    too with a warning — replay must survive exactly the failure it
    exists for."""
    intents: dict[str, Intent] = {}
    state: dict[str, object] = {}
    records = 0
    max_seq = 0
    if not os.path.exists(path):
        return [], {}, 0, 0
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                log.warning("journal: skipping torn record", path=path,
                            line=lineno)
                continue
            records += 1
            kind = rec.get("rec")
            if kind == "intent":
                intent = Intent(id=rec["id"], kind=rec.get("kind", ""),
                                payload=rec.get("payload") or {})
                intents[intent.id] = intent
                try:
                    max_seq = max(max_seq,
                                  int(intent.id.rsplit("-", 1)[-1]))
                except ValueError:
                    pass
            elif kind == "note":
                i = intents.get(rec.get("id", ""))
                if i is not None:
                    i.notes[rec.get("stage", "")] = rec.get("data") or {}
            elif kind == "done":
                i = intents.get(rec.get("id", ""))
                if i is not None:
                    i.outcome = rec.get("outcome", "ok")
                # a done whose intent record was torn still spends its id
                try:
                    max_seq = max(max_seq, int(
                        rec.get("id", "").rsplit("-", 1)[-1]))
                except ValueError:
                    pass
            elif kind == "state":
                key = rec.get("key", "")
                value = rec.get("value")
                if value is None:
                    state.pop(key, None)
                else:
                    state[key] = value
            elif kind == "seq":
                # compaction checkpoint: ids below this are spent even
                # though their intents were dropped from the file
                try:
                    max_seq = max(max_seq, int(rec.get("n", 0)))
                except (TypeError, ValueError):
                    pass
    return list(intents.values()), state, records, max_seq
