"""Replayable event trace: the determinism contract's witness.

Every chaos decision (injected fault, storm, partial list), every round
summary, and every invariant result is appended as one dict.  The trace
deliberately excludes anything non-deterministic across identical
(profile, seed) runs — no wall timestamps (virtual offsets only), no
uuid-derived claim/instance names — so ``digest()`` is a stable
fingerprint: the runner executes every scenario twice and compares
digests, which is how "same seed => identical event trace" is enforced
rather than assumed.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path


class EventTrace:
    def __init__(self):
        self.events: list[dict] = []

    def add(self, kind: str, **fields) -> None:
        self.events.append({"kind": kind, **fields})

    def __len__(self) -> int:
        return len(self.events)

    def of_kind(self, kind: str) -> list[dict]:
        return [e for e in self.events if e["kind"] == kind]

    def digest(self) -> str:
        """Content hash over the canonical JSON encoding."""
        h = hashlib.sha256()
        for e in self.events:
            h.update(json.dumps(e, sort_keys=True).encode())
            h.update(b"\n")
        return h.hexdigest()

    def dump(self, path: str | Path) -> Path:
        """Write one JSON object per line (the CI failure artifact)."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with p.open("w") as f:
            for e in self.events:
                f.write(json.dumps(e, sort_keys=True) + "\n")
        return p
